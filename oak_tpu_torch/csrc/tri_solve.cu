// Triangular solve with a wide right-hand side for Hopper (sm_90a):
//
//   X = L^-1 B   (forward)   or   X = L^-T B   (transposed),
//
// L [M, M] lower-triangular (only its lower triangle is read), B and X
// [M, N], float32, row-major and contiguous, with a lane axis: lane l solves
// its own L (or one L that every lane shares) against its own B (or a shared
// one) on the blocks whose blockIdx.y is l. The training bounds take it for
// A = L^-1 Kuf and, in autograd's backward, dKuf = L^-T dA
// (oak_tpu_torch/ops/tri_solve.py); the Cholesky's reverse pass for its two
// square solves L^-T P and L^-T Y^T (oak_tpu_torch/ops/psd.py).
//
// It replaces no TPU kernel: oak_tpu left its triangular solves to XLA. It
// was added because cuBLAS's trsm ran these wide solves at 12-14 % of the
// card's FP32 rate, the largest single share of the training step's device
// time.
//
// What bounds it on this card: M^2 N / 2 FFMAs a lane (512 x 8192: 1.07 G,
// 32 us at 33.5 TFMA/s), while only 4 (M^2 / 2 + 2 M N) bytes need to move
// (0.01 ms). The recurrence runs down the rows (up, transposed), so the
// parallelism is across columns.
//
// Design: a block owns one lane and one panel of NB columns (64, 32 or 16:
// oak_tri_solve_panel chooses from M, N and the lanes, by the waves over
// the SMs and whether M fits a panel's shared memory) and keeps the
// panel's solved rows of X in shared memory (M x NB floats), so that the
// product's right operand never leaves the SM. It walks L in blocks of 32
// rows, down (up, transposed). For row block i it forms R = B_i - L_i,<i
// X_<i (transposed: B_i - (L^T)_i,>i X_>i, read from L's column panel in
// place) by a register-tiled FP32 product: each of 256 threads accumulates
// 4 rows x 4 columns, and the block's 128 / NB k groups each take every
// (128 / NB)-th k of a staged tile. The tiles of L (64 k x 32 rows) stream
// through two shared buffers by cp.async, the next in flight while one is
// multiplied; B_i and D_i are loaded a step ahead. Then X_i = D_i R, where
// D_i is the inverse of L's 32 x 32 diagonal block (D_i^T transposed), the
// k groups' partial sums added as it reads them; a first kernel inverts
// every diagonal block by forward substitution, as blocked trsm routines
// do. FP32 throughout, no TF32. A NaN in L's lower triangle or in B reaches
// X; rows past M (M need not be a multiple of 32) read and hold 0, and
// columns past N are never stored. Copies and stores are of single floats,
// so N and M need no alignment. Past 1,504 rows no panel fits, and the
// wrapper splits L.
//
// Measured on an H100 (PERF.md): at 512 x 8192 about 0.13 ms a form, a
// quarter of the FP32 bound and 2.6 times cuBLAS's trsm; clock64() put 70 %
// of a block's cycles in the product's loop, which issues about one
// instruction in two cycles a scheduler whatever the thread tile, the
// number of warps or the depth of the copy pipeline.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace oak_trsm {

constexpr int kBlock = 32;        // rows of a diagonal block: one step of the walk
constexpr int kDepth = 64;        // k of one staged tile of L
constexpr int kStages = 2;        // tiles of L in flight or in use
constexpr int kPad = kBlock + 4;  // row stride of the staged tiles (16-byte rows)
constexpr int kThreads = 256;     // 8 row groups x NB / 4 column groups x k groups

// k groups of the solve kernel at panel width nb (16, 32 or 64 columns)
__host__ __device__ constexpr int k_groups(int nb) { return 128 / nb; }

// Shared memory of the solve kernel at panel width nb over mpad rows: the
// panel of X, the ring of tiles of L, the k groups' partial sums and D_i.
inline size_t smem_bytes(int nb, int mpad) {
  return sizeof(float) * ((size_t)mpad * nb + kStages * kDepth * kPad +
                          (size_t)k_groups(nb) * kBlock * nb + kBlock * kPad);
}

// cp.async of one float into shared memory; zero-filled where !pred (no
// read of src then).
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n of this thread's latest groups of copies are pending.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The inverse of each 32 x 32 diagonal block of L, by forward substitution:
// thread c computes column c in registers, four partial sums a row. Dinv is
// [lanes][nblk][32][32], row-major, 0 above the diagonal and past M.
__global__ void __launch_bounds__(kBlock)
    diag_inv_kernel(const float* __restrict__ L, float* __restrict__ Dinv, int M,
                    long long sL) {
  __shared__ float Lb[kBlock][kBlock + 1];
  const int b = blockIdx.x, c = threadIdx.x;
  L += blockIdx.y * sL;
  Dinv += ((long long)blockIdx.y * gridDim.x + b) * kBlock * kBlock;
  const int r0 = b * kBlock, n = min(kBlock, M - r0);
  float v[kBlock];  // all 32 loads in flight at once
#pragma unroll
  for (int r = 0; r < kBlock; ++r)
    v[r] = (r < n && c < n && c <= r) ? __ldg(L + (size_t)(r0 + r) * M + r0 + c) : 0.f;
#pragma unroll
  for (int r = 0; r < kBlock; ++r)
    Lb[r][c] = (r >= n || c >= n) && r == c ? 1.f : v[r];  // rows past M: the identity
  __syncwarp();
  float inv[kBlock];  // inv[k] is 0 for k < c
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
    float s[4] = {r == c ? 1.f : 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < r; ++k) s[k % 4] = fmaf(-Lb[r][k], inv[k], s[k % 4]);
    inv[r] = r < c ? 0.f : ((s[0] + s[1]) + (s[2] + s[3])) / Lb[r][r];
  }
#pragma unroll
  for (int r = 0; r < kBlock; ++r) Dinv[r * kBlock + c] = (r < n && c < n) ? inv[r] : 0.f;
}

// CT consecutive floats from shared memory, as float4s, one float2 or one
// float.
template <int CT>
__device__ __forceinline__ void load_row(const float* p, float (&v)[CT]) {
  if constexpr (CT == 1) {
    v[0] = *p;
  } else if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CT; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
    }
  } else {
    static_assert(CT == 2, "a row of 1, 2 or a multiple of 4 floats");
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  }
}

template <int NB, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
    tri_solve_kernel(const float* __restrict__ L, const float* __restrict__ Dinv,
                     const float* __restrict__ B, float* __restrict__ X, int M, int N,
                     long long sL, long long sD, long long sB) {
  constexpr int T = kThreads, RT = 4, CW = 4;     // RT x CW outputs a thread
  constexpr int KG = k_groups(NB);                // k groups
  constexpr int RG = kBlock / RT, CG = NB / CW;  // row and column groups of the product
  constexpr int LPT = kDepth * kBlock / T;        // values of a tile of L a thread copies
  constexpr int DPT = kBlock * kBlock / T;        // values of D_i a thread loads
  constexpr int CT = NB * 16 / T;                 // columns a thread solves in X_i = D_i R
  static_assert(RG * CG * KG == T && kBlock % KG == 0 && (CT == 1 || CT % 2 == 0),
                "thread layout");

  extern __shared__ float4 smem4[];
  const int nblk = (M + kBlock - 1) / kBlock;
  const int mpad = nblk * kBlock;
  float* Xs = reinterpret_cast<float*>(smem4);  // [mpad][NB] the panel of X
  float* Ls = Xs + (size_t)mpad * NB;           // [kStages][kDepth][kPad] tiles of L, [k][m]
  float* Ps = Ls + kStages * kDepth * kPad;     // [KG][kBlock][NB] partial sums
  float* Ds = Ps + KG * kBlock * NB;            // [kBlock][kPad] D_i as [k][m]

  const int tid = threadIdx.x;
  const int rg = tid % RG, cg = (tid / RG) % CG, kg = tid / (RG * CG);
  const int p0 = blockIdx.x * NB;
  const int ncols = min(NB, N - p0);
  const long long lane = blockIdx.y;
  L += lane * sL;
  Dinv += lane * sD;
  B += lane * sB;
  X += lane * (long long)M * N;

  // Step s solves row block i(s); its product runs over k in [k_begin,
  // k_end), a multiple of 32, in tiles of kDepth. Step 0 has none, every
  // later step at least one.
  auto block_of = [&](int s) { return TRANS ? nblk - 1 - s : s; };
  auto k_begin = [&](int s) { return TRANS ? (block_of(s) + 1) * kBlock : 0; };
  auto k_end = [&](int s) { return TRANS ? mpad : block_of(s) * kBlock; };
  auto nchunk = [&](int s) { return (k_end(s) - k_begin(s) + kDepth - 1) / kDepth; };

  // Tile ch of step s of the product's left operand A[m][k] (A = L, or L^T
  // transposed) into buf as [k][m], zero at k >= k_end and past M; each
  // warp reads 32 consecutive floats of one row of L.
  auto copy_tile = [&](float* buf, int s, int ch) {
    const int r0 = block_of(s) * kBlock, k0 = k_begin(s) + ch * kDepth, kend = k_end(s);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int e = tid + j * T;
      const int m = TRANS ? e % kBlock : e / kDepth;
      const int k = TRANS ? e / kBlock : e % kDepth;
      const int row = TRANS ? k0 + k : r0 + m;
      const int col = TRANS ? r0 + m : k0 + k;
      const bool ok = k0 + k < kend && row < M && col < M;
      copy_async(buf + k * kPad + m, ok ? L + (size_t)row * M + col : L, ok);
    }
  };
  // B_i of step s, in the layout of the first k group's accumulators, and
  // D_i
  auto load_bd = [&](float (&bacc)[RT][CW], float (&dreg)[DPT], int s) {
    const int r0 = block_of(s) * kBlock;
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int row = r0 + RT * rg + r, col = CW * cg + c;
          bacc[r][c] = (row < M && col < ncols) ? __ldg(B + (size_t)row * N + p0 + col) : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j) dreg[j] = __ldg(Dinv + (size_t)r0 * kBlock + tid + j * T);
  };

  float acc[RT][CW];
  auto step = [&](const float* buf, int k0, int kk) {
    float av[RT], bv[CW];
    load_row<RT>(buf + kk * kPad + RT * rg, av);
    load_row<CW>(Xs + (size_t)(k0 + kk) * NB + CW * cg, bv);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  };

  // The tiles of all steps form one sequence, (s, ch) for s >= 1, streamed
  // through a ring of kStages buffers by cp.async: the next tiles are in
  // flight while one is multiplied. B and D of step s + 1 are loaded during
  // step s's diagonal solve.
  int next_s = 1, next_ch = 0;  // the next tile to copy
  auto copy_next = [&](int slot) {
    if (next_s < nblk) {
      copy_tile(Ls + slot * kDepth * kPad, next_s, next_ch);
      if (++next_ch == nchunk(next_s)) ++next_s, next_ch = 0;
    }
    copy_commit();  // an empty group past the end keeps the count
  };
  float bacc[RT][CW], dreg[DPT];
  load_bd(bacc, dreg, 0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) copy_next(st);
  int tile = 0;  // the sequence number of the next tile to multiply
  for (int s = 0; s < nblk; ++s) {
    const int r0 = block_of(s) * kBlock;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
    for (int ch = 0; ch < nchunk(s); ++ch, ++tile) {
      copy_wait<kStages - 2>();
      __syncthreads();  // the tile has landed, and every thread is past the previous
      copy_next((tile + kStages - 1) % kStages);
      const int k0 = k_begin(s) + ch * kDepth;
      const float* cur = Ls + (tile % kStages) * kDepth * kPad;
#pragma unroll
      for (int h = 0; h < kDepth / kBlock; ++h) {
        if (h == 0 || k_end(s) - k0 > h * kBlock) {  // the tile's h-th 32 k
#pragma unroll
          for (int q = 0; q < kBlock / KG; ++q) step(cur, k0, h * kBlock + kg + q * KG);
        }
      }
    }

    // this k group's partial sums, the first group's less B_i, so that they
    // add up to -R = L_i,<i X_<i - B_i; D_i as the coefficient Ds[k][m] of
    // R[k] in X[m]
    float* Pg = Ps + kg * kBlock * NB;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CW; c += 4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = kg == 0 ? acc[r][c + q] - bacc[r][c + q] : acc[r][c + q];
        *reinterpret_cast<float4*>(Pg + (RT * rg + r) * NB + CW * cg + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int e = tid + j * T, r = e / kBlock, c = e % kBlock;
      Ds[TRANS ? r * kPad + c : c * kPad + r] = dreg[j];
    }
    if (s + 1 < nblk) load_bd(bacc, dreg, s + 1);
    __syncthreads();

    // X_i = D_i R: rows m and 31 - m, CT columns a thread, over all 32 k
    // (D_i's coefficients outside its triangle are 0, which adds nothing)
    {
      const int c0 = (tid % (T / 16)) * CT, m0 = tid / (T / 16), m1 = kBlock - 1 - m0;
      float x0[CT], x1[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) x0[c] = x1[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        float nr[CT];  // -R[k]
        load_row<CT>(Ps + k * NB + c0, nr);
#pragma unroll
        for (int g = 1; g < KG; ++g) {
          float pv[CT];
          load_row<CT>(Ps + g * kBlock * NB + k * NB + c0, pv);
#pragma unroll
          for (int c = 0; c < CT; ++c) nr[c] += pv[c];
        }
        const float d0 = Ds[k * kPad + m0], d1 = Ds[k * kPad + m1];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          x0[c] = fmaf(d0, nr[c], x0[c]);
          x1[c] = fmaf(d1, nr[c], x1[c]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + (h ? m1 : m0);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float x = -(h ? x1[c] : x0[c]);
          Xs[(size_t)row * NB + c0 + c] = row < M ? x : 0.f;
          if (row < M && c0 + c < ncols) X[(size_t)row * N + p0 + c0 + c] = x;
        }
      }
    }
    __syncthreads();
  }
}

template <int NB, bool TRANS>
cudaError_t launch(const float* L, const float* D, const float* B, float* X, int M, int N,
                   int lanes, long long sL, long long sD, long long sB, cudaStream_t s) {
  const int mpad = (M + kBlock - 1) / kBlock * kBlock;
  const size_t bytes = smem_bytes(NB, mpad);
  auto kern = tri_solve_kernel<NB, TRANS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + NB - 1) / NB, lanes);
  kern<<<grid, kThreads, bytes, s>>>(L, D, B, X, M, N, sL, sD, sB);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_form(bool trans, const float* L, const float* D, const float* B, float* X,
                        int M, int N, int lanes, long long sL, long long sD, long long sB,
                        cudaStream_t s) {
  return trans ? launch<NB, true>(L, D, B, X, M, N, lanes, sL, sD, sB, s)
               : launch<NB, false>(L, D, B, X, M, N, lanes, sL, sD, sB, s);
}

// Blocks of kernel<NB> an SM holds at mpad rows (0 where it does not fit).
template <int NB>
int occupancy(int mpad, int optin) {
  const size_t bytes = smem_bytes(NB, mpad);
  if (bytes > (size_t)optin) return 0;
  auto kern = tri_solve_kernel<NB, false>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) !=
      cudaSuccess)
    return 0;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, bytes) !=
      cudaSuccess)
    return 0;
  return occ;
}

}  // namespace oak_trsm

using namespace oak_trsm;

// The panel width for M rows, N columns and `lanes` lanes on the current
// device: of 64, 32 and 16 columns, the one whose waves over the SMs take
// the least time, counting a block's time as kWalk + its width, times the
// blocks that share its SM; the wider on a tie. kWalk stands for the walk
// down the row blocks that every panel pays whatever its width: on an H100
// at M 512 a lone block took 0.081, 0.096 and 0.128 ms at widths 16, 32 and
// 64, about (65 + width) us. So the narrow panels win where the blocks of
// one underfill the card (a square right-hand side), and the wide ones where
// the blocks come in waves (N >> M). 16 columns are taken only where 32 fit
// too: they narrow a panel for parallelism, not for height, so an L past
// 1,504 rows is split as before. 0 when M is too tall for a panel's shared
// memory (the wrapper then splits L). Returns a cudaError_t.
extern "C" int oak_tri_solve_panel(int M, int N, int lanes, int* nb) {
  *nb = 0;
  if (M < 1 || N < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int mpad = (M + kBlock - 1) / kBlock * kBlock;
  constexpr int kWalk = 64;
  const int widths[3] = {64, 32, 16};
  const int occ32 = occupancy<32>(mpad, optin);
  const int occs[3] = {occupancy<64>(mpad, optin), occ32,
                       occ32 > 0 ? occupancy<16>(mpad, optin) : 0};
  long long best = -1;
  for (int v = 0; v < 3; ++v) {
    if (occs[v] < 1) continue;
    const long long blocks = (long long)lanes * ((N + widths[v] - 1) / widths[v]);
    const long long per_wave = (long long)sms * occs[v];
    const long long waves = (blocks + per_wave - 1) / per_wave;
    const long long sharing = std::min<long long>(occs[v], (blocks + sms - 1) / sms);
    const long long cost = waves * sharing * (kWalk + widths[v]);
    if (best < 0 || cost < best) best = cost, *nb = widths[v];
  }
  return 0;
}

// Floats of workspace (the diagonal blocks' inverses) for M rows and lanes_L
// distinct L.
extern "C" long long oak_tri_solve_workspace(int M, int lanes_L) {
  return (long long)lanes_L * ((M + kBlock - 1) / kBlock) * kBlock * kBlock;
}

// X = L^-1 B, or L^-T B with transpose, for `lanes` lanes at panel width nb
// (from oak_tri_solve_panel). L has lane stride sL (M * M, or 0 when every
// lane shares it; lanes_L is then 1), B lane stride sB (M * N or 0), X is
// [lanes, M, N]; work holds oak_tri_solve_workspace(M, lanes_L) floats.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int oak_tri_solve_f32(const float* L, const float* B, float* X, float* work, int M,
                                 int N, int lanes, int lanes_L, int transpose, int nb,
                                 long long sL, long long sB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || lanes < 1 || lanes > 65535 || sL < 0 || sB < 0 ||
      (lanes_L != 1 && lanes_L != lanes) || (lanes_L == 1) != (sL == 0 || lanes == 1))
    return (int)cudaErrorInvalidValue;
  const int nblk = (M + kBlock - 1) / kBlock;
  diag_inv_kernel<<<dim3(nblk, lanes_L), kBlock, 0, s>>>(L, work, M, sL);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long sD = lanes_L > 1 ? (long long)nblk * kBlock * kBlock : 0;
  const bool trans = transpose != 0;
  switch (nb) {
    case 64: return (int)launch_form<64>(trans, L, work, B, X, M, N, lanes, sL, sD, sB, s);
    case 32: return (int)launch_form<32>(trans, L, work, B, X, M, N, lanes, sL, sD, sB, s);
    case 16: return (int)launch_form<16>(trans, L, work, B, X, M, N, lanes, sL, sD, sB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
