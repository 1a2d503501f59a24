// The lower triangle of a long-K product for Hopper (sm_90a):
//
//   C = alpha * tril(P Q^T)                  (tril form)
//   C = alpha * P P^T, written mirrored      (symmetric form, Q is P)
//
// P and Q [M, K], C [M, M], float32, row-major and contiguous, with a lane
// axis: lane l multiplies its own P and Q (or one that every lane shares) on
// the blocks whose blockIdx.z is l. The training bounds take it for the
// SGPR bound's A A^T (symmetric, A = L^-1 Kuf / sigma [M, N]) and for the
// wide solve's backward dL = -tril(dB X^T) (oak_tpu_torch/ops/gemmt.py).
//
// It replaces no TPU kernel: oak_tpu left these products to XLA. It was
// added because cuBLAS ran both as full M x M products, each tile of its
// output walking all of K, at about half the card's FP32 rate, while the
// bound needs only one triangle; the three GEMMs of those products led the
// SGPR cell's device time.
//
// What bounds it on this card: M (M + 1) / 2 * K FFMAs a lane (4 lanes x
// 500 x 6553: 3.28 G, 0.098 ms at 33.5 TFMA/s); the bytes, 4 (2 M K + M^2),
// take a fifth of that.
//
// Design: only the output tiles on or below the diagonal are computed, 64 x
// 64 each (128-row tiles were slower at every shape the bounds run, and won
// only from about 2,000 rows). K is split across the S blocks of a thread
// block cluster (S 1 to 16), so that a few dozen tiles still fill the 132
// SMs: oak_gemmt_plan chooses S from (M, K, lanes) by the waves of clusters
// over the SMs, as oak_tri_solve_panel chooses its panel. A block
// streams its k range of both operands through a ring of shared buffers by
// cp.async of single floats (rows and k past the ends read as 0, so M and K
// need no alignment: the SGPR cell's K, 6553 rows, is odd), stored [k][m]
// so that each thread reads its 8 + 8 operands as four float4s and
// accumulates an 8 x 8 register tile by FFMA (64 FFMAs to 4 shared loads).
// A block with the whole k range writes its tile from shared
// memory; with a split, each block puts its partial tile in its own shared
// memory and, after a cluster barrier, the block of rank r sums the r-th
// band of rows of the S partials, read across the cluster (distributed
// shared memory), in the fixed order 0..S-1: no atomics, so two calls give
// the same bits. That pass applies alpha and writes the band's lower part
// row by row and its mirror (the symmetric form) or zeros (tril) column by
// column, so C is written whole by the one launch. FP32 throughout, no
// TF32. NaN in P or Q reaches C.
//
// Measured on an H100 (PERF.md): 0.255 ms at 4 x 500 x 6553 against
// cuBLAS's full product's 0.36, 0.38 of the FP32 bound; 0.100 ms at 512 x
// 8192 (cuBLAS 0.101); 0.012 ms at 4 x 200 x 237 (cuBLAS 0.008), where a
// launch's fixed costs rule. Loading the operands alone (no FFMAs) takes
// about as long as the FFMAs alone, and the two add rather than overlap;
// neither 16-byte copies, register staging, deeper rings nor 16 x 8 thread
// tiles moved that. The code is kept small: a second, diagonal copy of the
// k loop (to skip the diagonal tiles' upper quarter) outgrew the
// instruction cache and cost 10-15 % everywhere.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace oak_gemmt {

constexpr int kBK = 16;       // k of one staged tile
constexpr int kStages = 3;    // staged tiles in flight or in use
constexpr int kMaxSplit = 16; // blocks of a cluster (past 8: non-portable)

struct Tile {
  static constexpr int BM = 64;                   // rows and columns of a tile of C
  static constexpr int TD = BM / 8;               // threads along each side
  static constexpr int NT = TD * TD;              // 64 threads
  static constexpr int H = BM / 2;                // the offset of a thread's second rows, columns
  static constexpr int LD = BM + 4;               // row stride of a staged [k][m] tile
  static constexpr int STAGE = 2 * kBK * LD;      // floats of a stage (P's and Q's)
  static constexpr int ROWS = NT / 8;             // rows a pass of the copy covers
  static constexpr int CPT = BM / ROWS;           // rows of an operand a thread copies a stage
  static constexpr int LDC = BM + 1;              // row stride of the partial tile
  static constexpr int MIN_BLOCKS = 5;            // up to 204 registers a thread
  static size_t smem_bytes() {
    return sizeof(float) * std::max<size_t>((size_t)kStages * STAGE, (size_t)BM * LDC);
  }
};

__device__ __forceinline__ void copy_async(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The lower tile t of a T x T grid of tiles, row by row: (0,0), (1,0),
// (1,1), (2,0), ...
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  ti = i, tj = t - i * (i + 1) / 2;
}

__global__ void __launch_bounds__(Tile::NT, Tile::MIN_BLOCKS)
    gemmt_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                 float* __restrict__ C, int M, int K, int kchunk, float alpha, int symmetric,
                 long long sP, long long sQ) {
  using G = Tile;
  constexpr int BM = G::BM, NT = G::NT, TD = G::TD, LD = G::LD, H = G::H;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int ti, tj;
  lower_tile(blockIdx.y, ti, tj);
  const int i0 = ti * BM, j0 = tj * BM;
  const long long lane = blockIdx.z;
  P += lane * sP;
  Q += lane * sQ;
  C += lane * (long long)M * M;

  const int tid = threadIdx.x;
  // the 8 x 8 tile of a thread: rows 4 ty + {0..3} and H + 4 ty + {0..3},
  // columns likewise by tx; a warp holds 4 ty by 8 tx
  const int warp = tid / 32, lid = tid % 32;
  const int ty = (warp / (TD / 8)) * 4 + lid / 8;
  const int tx = (warp % (TD / 8)) * 8 + lid % 8;
  // row or column of a thread's 8 by its index
  auto at = [&](int t, int i) { return 4 * t + i % 4 + i / 4 * H; };

  const int k_begin = min(K, rank * kchunk), k_end = min(K, k_begin + kchunk);
  const int nst = (k_end - k_begin + kBK - 1) / kBK;

  // A thread copies k = k0 + ck and k0 + ck + 8 of rows cm + c ROWS, c <
  // CPT, of both operands: each warp reads 8 consecutive floats of 4 rows,
  // and its stores fill the 32 banks once.
  const int ck = tid % 8, cm = tid / 8;
  const float* Pr = P + (size_t)(i0 + cm) * K + ck;
  const float* Qr = Q + (size_t)(j0 + cm) * K + ck;
  auto copy_stage = [&](int slot, int k0) {
    float* As = smem + slot * G::STAGE;
    float* Bs = As + kBK * LD;
#pragma unroll
    for (int h = 0; h < kBK; h += 8) {
      const bool kin = k0 + h + ck < k_end;
#pragma unroll
      for (int c = 0; c < G::CPT; ++c) {
        const int m = cm + c * G::ROWS;
        const size_t off = (size_t)c * G::ROWS * K + k0 + h;
        const bool pa = kin && i0 + m < M, pb = kin && j0 + m < M;
        copy_async(As + (h + ck) * LD + m, pa ? Pr + off : P, pa);
        copy_async(Bs + (h + ck) * LD + m, pb ? Qr + off : Q, pb);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // The k loop, through a ring of kStages buffers: the next stages are in
  // flight while one is multiplied. (A diagonal tile computes its upper
  // part too: a loop of its own for it made the kernel's code outgrow the
  // instruction cache, which cost more than the skipped FFMAs saved.)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) copy_stage(st, k_begin + st * kBK);
    copy_commit();
  }
  for (int t = 0; t < nst; ++t) {
    copy_wait<kStages - 2>();
    __syncthreads();  // stage t has landed, and every thread is past stage t - 1
    const int next = t + kStages - 1;
    if (next < nst) copy_stage(next % kStages, k_begin + next * kBK);
    copy_commit();
    const float* As = smem + (t % kStages) * G::STAGE;
    const float* Bs = As + kBK * LD;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(As + kk * LD + 4 * ty + h * H);
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * LD + 4 * tx + h * H);
        a[4 * h] = u.x, a[4 * h + 1] = u.y, a[4 * h + 2] = u.z, a[4 * h + 3] = u.w;
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  copy_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  float* Cs = smem;  // [BM][LDC]
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) Cs[at(ty, r) * G::LDC + at(tx, c)] = acc[r][c];

  // This block's band of the tile's rows, [row0, row1): with a split, each
  // element summed over the cluster's partials in the fixed order 0..S-1
  // (the reads of a batch of elements from one partial in flight
  // together) and put back in place, where no other block reads.
  const int row0 = rank * BM / S, row1 = (rank + 1) * BM / S, rows = row1 - row0;
  if (S > 1) {
    cluster.sync();  // every partial of the cluster is in place
    constexpr int kBatch = 8;
    for (int eb = row0 * BM + tid; eb < row1 * BM; eb += kBatch * NT) {
      float sum[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) sum[q] = 0.f;
      for (int s = 0; s < S; ++s) {
        const float* part = cluster.map_shared_rank(Cs, s);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = eb + q * NT;
          if (e < row1 * BM) sum[q] += part[e / BM * G::LDC + e % BM];
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = eb + q * NT;
        if (e < row1 * BM) Cs[e / BM * G::LDC + e % BM] = sum[q];
      }
    }
    cluster.sync();  // no block leaves, or overwrites, while another reads its partial
  } else {
    __syncthreads();
  }

  // The band's part of C: its lower part, row by row, alpha times the sums;
  // their mirror above the diagonal (the same values, or 0 in the tril
  // form), column by column of the band, so that the writes of a warp are
  // consecutive in C both ways.
  const bool diag = ti == tj;
  constexpr int kBatch = 8;  // elements a thread reads before it writes them
  for (int eb = row0 * BM + tid; eb < row1 * BM; eb += kBatch * NT) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = min(eb + q * NT, row1 * BM - 1);
      v[q] = Cs[e / BM * G::LDC + e % BM];
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = eb + q * NT, r = e / BM, c = e % BM;
      if (e < row1 * BM && i0 + r < M && j0 + c < M && (!diag || r >= c))
        C[(size_t)(i0 + r) * M + j0 + c] = alpha * v[q];
    }
  }
  // the mirror's (c, r) in steps of NT through the band's BM x rows, r
  // fastest
  const int dc = NT / rows, dr = NT % rows;
  for (int c0 = tid / rows, r0 = tid % rows; c0 < BM;) {
    int cq[kBatch], rq[kBatch];
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      cq[q] = c0, rq[q] = row0 + r0;
      v[q] = Cs[rq[q] * G::LDC + min(c0, BM - 1)];
      c0 += dc, r0 += dr;
      if (r0 >= rows) r0 -= rows, ++c0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = rq[q], c = cq[q];
      if (c < BM && i0 + r < M && j0 + c < M && (!diag || r > c))
        C[(size_t)(j0 + c) * M + i0 + r] = symmetric ? alpha * v[q] : 0.f;
    }
  }
}

// The kernel's attributes for a cluster of `split` blocks on the current
// device, set once by oak_gemmt_plan for each split it weighs (cost below).
cudaError_t prepare(int split) {
  auto kern = gemmt_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile::smem_bytes());
  if (err == cudaSuccess && split > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(dim3 grid, int split, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Tile::NT);
  cfg.dynamicSmemBytes = Tile::smem_bytes();
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch(const float* P, const float* Q, float* C, int M, int K, int lanes,
                   float alpha, int symmetric, int split, long long sP, long long sQ,
                   cudaStream_t s) {
  const int T = (M + Tile::BM - 1) / Tile::BM;
  const int nk = (K + kBK - 1) / kBK;
  const int kchunk = (nk + split - 1) / split * kBK;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(dim3(split, T * (T + 1) / 2, lanes), split, s, &attr);
  if (split == 1) cfg.numAttrs = 0;  // a cluster of one: a plain launch
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemmt_kernel, P, Q, C, M, K, kchunk, alpha, symmetric,
                           sP, sQ);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The model's time with split S, or a negative number where the
// card cannot hold one such cluster: each wave of clusters over the SMs
// takes the blocks an SM shares times a block's work, its k range plus
// kFixed k of fixed cost (the ring's fill, the writes) and kPerSplit k for
// each partial of the cluster it reads, slowed where the SM holds fewer
// than kFullWarps warps. The constants fit device-time sweeps of every
// split at twelve shapes on an H100 (PERF.md).
double cost(int M, int K, int lanes, int split, int sms) {
  constexpr int kFixed = 144, kPerSplit = 4, kFullWarps = 8;
  if (prepare(split) != cudaSuccess) return -1.0;
  int occ = 0, clusters = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gemmt_kernel, Tile::NT,
                                                    Tile::smem_bytes()) != cudaSuccess ||
      occ < 1)
    return -1.0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(dim3(split, 1, 1), split, 0, &attr);
  if (cudaOccupancyMaxActiveClusters(&clusters, gemmt_kernel, &cfg) != cudaSuccess ||
      clusters < 1)
    return -1.0;
  const int T = (M + Tile::BM - 1) / Tile::BM;
  const long long tiles = (long long)lanes * T * (T + 1) / 2;
  const long long waves = (tiles + clusters - 1) / clusters;
  const long long wave_blocks = std::min<long long>(tiles, clusters) * split;
  const long long sharing = std::min<long long>(occ, (wave_blocks + sms - 1) / sms);
  const double rate = std::min(1.0, (double)sharing * Tile::NT / 32 / kFullWarps);
  const int nk = (K + kBK - 1) / kBK;
  const double k = (double)((nk + split - 1) / split * kBK + kFixed + kPerSplit * split);
  return (double)waves * sharing * k / rate;
}

}  // namespace oak_gemmt

using namespace oak_gemmt;

// The split of K for M, K and `lanes` lanes on the current device: the one
// of least modelled time (cost above); the fewer blocks on a tie. The
// splits are those at which sweeps on an H100 found the cluster scheduler
// spreading the blocks evenly; 7, 9-11 and 13-15 left some SMs a block
// more than others, up to a quarter slower (PERF.md). Returns a
// cudaError_t.
extern "C" int oak_gemmt_plan(int M, int K, int lanes, int* split) {
  *split = 0;
  if (M < 1 || K < 0 || lanes < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int nk = std::max(1, (K + kBK - 1) / kBK);
  double best = -1.0;
  for (int s : {1, 2, 3, 4, 5, 6, 8, 12, 16}) {
    if (s > nk) break;
    const double c = cost(M, K, lanes, s, sms);
    if (c >= 0 && (best < 0 || c < best)) best = c, *split = s;
  }
  cudaGetLastError();  // a refused cluster size leaves no error behind
  return best < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// C = alpha tril(P Q^T), or alpha P P^T mirrored with `symmetric` (Q is P),
// for `lanes` lanes at a split of K that oak_gemmt_plan chose on this device
// (which set the kernel's attributes for it). P and Q have lane
// strides sP and sQ (M * K, or 0 where every lane shares the operand); C is
// [lanes, M, M]. Returns the cudaError_t of the launch (0 on success).
extern "C" int oak_gemmt_f32(const float* P, const float* Q, float* C, int M, int K,
                             int lanes, float alpha, int symmetric, int split, long long sP,
                             long long sQ, void* stream) {
  if (M < 1 || K < 0 || lanes < 1 || lanes > 65535 || sP < 0 || sQ < 0 || split < 1 ||
      split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const long long T = (M + Tile::BM - 1) / Tile::BM;
  if (T * (T + 1) / 2 > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch(P, Q, C, M, K, lanes, alpha, symmetric, split, sP, sQ,
                     static_cast<cudaStream_t>(stream));
}
