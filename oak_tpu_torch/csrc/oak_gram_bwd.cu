// Fused OAK gram backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oak_tpu/ops/oak_gram_pallas.py::_gram_bwd_kernel
// (launched by _pallas_gram_bwd), and covers the extra (binary, categorical)
// grams too, as oak_tpu's _res_bwd does and the TPU kernel did not. For a
// cotangent gbar [N, M] of out = oak_gram_fwd_f32(...) it recomputes, per
// output element (i, j),
//
//   bE_d = exp(logb[d] - (u1[d,i] - u2[d,j])^2),  g_d = bE_d - c1[d,i] c2[d,j]
//   e_1..e_P                          (the product expansion, oak_gram_common.cuh)
//
// and then, per dim, the downdate h_0 = 1, h_k = e_k - g_d h_{k-1} (so that
// h_k is e_k of the other grams) and
//
//   W_d = sum_{n=1..P} sig2[n] h_{n-1},   T_d = gbar W_d   (= gbar dout/dg_d)
//
// T_d is evaluated as a polynomial in g_d whose coefficients are formed once
// per element after pass 1 (see there), by P - 1 FFMAs per (element, dim).
//
//   du1[d,i]  = -2 sum_j T bE du      du2[d,j]  = +2 sum_i T bE du
//   dc1[d,i]  =   -sum_j T c2         dc2[d,j]  =   -sum_i T c1
//   dlogb[d]  =    sum_ij T bE        dsig2[n]  =    sum_ij gbar e_n
//   dextra[e,i,j] = gbar W_{D+e}
//
// with du = u1[d,i] - u2[d,j]. Layouts, all float32 and contiguous: u1, c1,
// du1, dc1 [D, N]; u2, c2, du2, dc2 [D, M]; extra, dextra [E, N, M]; logb,
// dlogb [D]; sig2, dsig2 [P + 1]; gbar [N, M]. P is the clamped depth, 1..64.
//
// What bounds it on this card: per (element, dim) two MUFU ex2 (the D grams
// of a tile do not fit on chip, where the TPU kernel kept them all in VMEM,
// so pass 2 recomputes them) and 3 + P FP32 operations in pass 1 plus
// 8 + P in pass 2 (du, the exponent, -g, P - 1 for T, T bE, five sums): 17
// at depth 3, so FP32 throughput bounds it (Kuf, 512 x 8192 at D = 32: 69 us
// at 1.98 GHz; the exps alone 64 us).
//
// Design: a block of 16 x 16 threads owns a tile of 16R x 16C elements, each
// thread a register micro-tile of R x C (4 x 4 at depth <= 4, 2 x 2 at 5..8,
// smaller for small grids and deeper variants; oak_gram_common.cuh). Two
// blocks of 128 registers a thread fill an SM; one block of more registers
// is slower, so the 4 x 4 tile at depth 2 keeps a 12-byte spill. The block
// stages its rows' and columns' u, c into shared memory as the forward does.
// Pass 1 keeps e_1..e_P of each element in registers, then sums dsig2 and
// turns e and gbar into T's P coefficients. Pass 2 runs over the dims: each
// thread sums its R row partials over its C columns and its C column
// partials over its R rows in registers, stores them to shared memory as
// float4 (R + R + C + C values per R x C element-dims), and after one
// barrier per two dims (8192 element-dims at 4 x 4) each thread sums two
// adjacent rows' or columns' 16 partials of a dim (8-byte loads, four chains
// and a fixed tree) and writes them as the tile's partials; one warp per dim
// sums dlogb over the block's threads. The shared buffers are double-
// buffered, so one barrier per two dims suffices. oak_gram_bwd_reduce then
// sums the per-tile partials in a fixed order: no atomics, the same inputs
// give the same bits.

#include "oak_gram_common.cuh"

namespace {

using namespace oak;

// Per-tile partials in the workspace, for a grid of blocks_n x blocks_m
// tiles (floats):
//   rowp [2, blocks_m, D, N]   du1, dc1 partials (one row per column tile)
//   colp [2, blocks_n, D, M]   du2, dc2 partials (one row per row tile)
//   dlogbp [blocks, D], dsig2p [blocks, P + 1]
struct Workspace {
  size_t rowp, colp, dlogbp, dsig2p, total;
};

Workspace workspace(int D, int N, int M, int P, int blocks_n, int blocks_m) {
  Workspace w;
  const size_t blocks = (size_t)blocks_n * blocks_m;
  w.rowp = 0;
  w.colp = w.rowp + 2 * (size_t)blocks_m * D * N;
  w.dlogbp = w.colp + 2 * (size_t)blocks_n * D * M;
  w.dsig2p = w.dlogbp + blocks * D;
  w.total = w.dsig2p + blocks * (P + 1);
  return w;
}

template <int PMAX, int R, int C>
struct BwdShape {
  static constexpr int BN = kThreadsY * R, BM = kThreadsX * C;
  // dims whose partials go through shared memory between two barriers
  static constexpr int KD = 2;
  // partial rows padded by 4 floats: the float4 stores of a quarter warp
  // land on distinct banks
  static constexpr int kRowStride = BN + 4, kColStride = BM + 4;
  static constexpr int kRedFloats = 2 * kThreadsX * kRowStride + 2 * kThreadsY * kColStride;
  static constexpr int kSmemFloats = 2 * kStageDims * (BN + BM) + kStageDims  // staging
                                     + 2 * KD * (kRedFloats + kThreads)       // partials
                                     + kWarps * (PMAX + 1) + (PMAX + 1);      // dsig2, sig2
  static constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
};

// Sums of the pairs src[2t], src[2t + 1] over t = 0..15 at a stride: one
// 8-byte load per pair, four interleaved chains and a fixed tree, so the
// order is the same every time at a quarter of the latency.
__device__ __forceinline__ void sum16x2(float (&out)[2], const float* src, int stride) {
  float v[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) load_vec<2>(v[k], src + k * stride);
#pragma unroll
  for (int t = 4; t < 16; t += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float x[2];
      load_vec<2>(x, src + (t + k) * stride);
      v[k][0] += x[0];
      v[k][1] += x[1];
    }
#pragma unroll
  for (int c = 0; c < 2; ++c) out[c] = (v[0][c] + v[1][c]) + (v[2][c] + v[3][c]);
}

template <int PMAX, int R, int C>
__global__ void __launch_bounds__(kThreads, R * C * (PMAX + 1) <= 64 ? 2 : 1)
oak_gram_bwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                    const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ extra,
                    const float* __restrict__ logb,
                    const float* __restrict__ sig2,
                    const float* __restrict__ gbar, float* __restrict__ rowp,
                    float* __restrict__ colp, float* __restrict__ dlogbp,
                    float* __restrict__ dsig2p, float* __restrict__ dextra,
                    int D, int N, int M, int E, int P_arg, int blocks_n,
                    int blocks_m) {
  using S = BwdShape<PMAX, R, C>;
  constexpr bool EXACT = PMAX <= 8;
  constexpr int BN = S::BN, BM = S::BM;
  const int P = EXACT ? PMAX : P_arg;
  extern __shared__ __align__(16) float smem[];
  float* s_u1 = smem;
  float* s_c1 = s_u1 + kStageDims * BN;
  float* s_u2 = s_c1 + kStageDims * BN;
  float* s_c2 = s_u2 + kStageDims * BM;
  float* s_red = s_c2 + kStageDims * BM;  // [2 buffers][KD][kRedFloats]
  float* s_db = s_red + 2 * S::KD * S::kRedFloats;  // [2 buffers][KD][kThreads]
  float* s_ds = s_db + 2 * S::KD * kThreads;  // [kWarps][PMAX + 1]
  float* s_sg = s_ds + kWarps * (PMAX + 1);  // [PMAX + 1]
  float* s_lb = s_sg + (PMAX + 1);  // [kStageDims]

  const int tile_i = blockIdx.x / blocks_m;
  const int tile_j = blockIdx.x - tile_i * blocks_m;
  const int row0 = tile_i * BN, col0 = tile_j * BM;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = col0 + tx * C;
  const size_t nm = (size_t)N * M;
  const bool vec = M % C == 0 && aligned_for<C>(gbar) &&
                   (E == 0 || (aligned_for<C>(extra) &&
                               (dextra == nullptr || aligned_for<C>(dextra))));

  for (int n = threadIdx.x; n <= P; n += kThreads) s_sg[n] = sig2[n];
  // sig2 in registers for the exact depths, from shared memory deeper
  float sg_r[EXACT ? PMAX + 1 : 1];
  if constexpr (EXACT) {
#pragma unroll
    for (int n = 0; n <= PMAX; ++n) sg_r[n] = sig2[n];
  }
  auto sg = [&](int n) -> float {
    if constexpr (EXACT) return sg_r[n];
    else return s_sg[n];
  };
  // T = gbar W for a gram g, by Horner in ng = -g over the coefficients of
  // the expanded downdate, a[k] = a_{P-1-k} (below)
  auto cotangent = [&](const float(&a)[PMAX], float ng) -> float {
    float t = a[0];
#pragma unroll
    for (int k = 1; k < PMAX; ++k)
      if (EXACT || k < P) t = fmaf(t, ng, a[k]);
    return t;
  };

  // pass 1: e_1..e_P of each element, then its cotangent and dsig2's sums
  float e[R][C][PMAX];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < PMAX; ++k) e[r][c][k] = 0.0f;
  const bool staged_once = D <= kStageDims;
  for (int d0 = 0; d0 < D; d0 += kStageDims) {
    const int kd = min(kStageDims, D - d0);
    __syncthreads();
    stage<BN, BM>(s_u1, s_c1, s_u2, s_c2, s_lb, u1, c1, u2, c2, logb, d0, kd,
                  row0, col0, N, M);
    __syncthreads();
#pragma unroll 1
    for (int d = 0; d < kd; ++d) {
      float a[R], ca[R], b[C], cb[C];
      load_vec<R>(a, s_u1 + d * BN + ty * R);
      load_vec<R>(ca, s_c1 + d * BN + ty * R);
      load_vec<C>(b, s_u2 + d * BM + tx * C);
      load_vec<C>(cb, s_c2 + d * BM + tx * C);
      const float lb = s_lb[d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float du = a[r] - b[c];
          const float g = fmaf(-ca[r], cb[c], fast_exp2(fmaf(-du, du, lb)));
          add_gram<PMAX, EXACT>(e[r][c], g, P);
        }
    }
  }
  for (int k = 0; k < E; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + ty * R + r;
      float x[C];
      load_run<C>(x, extra + k * nm + (size_t)i * M + j0, i < N ? M - j0 : 0, vec);
#pragma unroll
      for (int c = 0; c < C; ++c) add_gram<PMAX, EXACT>(e[r][c], x[c], P);
    }
  }
  float gb[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty * R + r;
    load_run<C>(gb[r], gbar + (size_t)i * M + j0, i < N ? M - j0 : 0, vec);
  }
  {
    float ds[PMAX + 1];
#pragma unroll
    for (int n = 0; n <= PMAX; ++n) ds[n] = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ds[0] += gb[r][c];
#pragma unroll
        for (int n = 1; n <= PMAX; ++n)
          if (EXACT || n <= P) ds[n] = fmaf(gb[r][c], e[r][c][n - 1], ds[n]);
      }
#pragma unroll
    for (int n = 0; n <= PMAX; ++n)
      if (EXACT || n <= P) {
        const float v = warp_sum(ds[n]);
        if (lane == 0) s_ds[warp * (PMAX + 1) + n] = v;
      }
  }
  __syncthreads();
  for (int n = threadIdx.x; n <= P; n += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_ds[w * (PMAX + 1) + n];
    dsig2p[(size_t)blockIdx.x * (P + 1) + n] = v;
  }

  // The downdate h_0 = 1, h_k = e_k - g h_{k-1} makes W(g) = sum_{n=1..P}
  // sig2[n] h_{n-1} a polynomial of degree P - 1 in g: T = gbar W =
  // sum_m a_m (-g)^m with a_m = gbar sum_{n=m+1..P} sig2[n] e_{n-1-m}. Each
  // element's a_0..a_{P-1} replace its e_1..e_P and gbar, so pass 2 costs
  // P - 1 FFMAs per (element, dim) for T where the downdate costs 2P - 1.
  // In place, slot k (which held e_{k+1}) takes a_{P-1-k} = gbar sum_{j=0..k}
  // sig2[P-k+j] e_j, for k from the top down: slot k reads e_0..e_k only.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = PMAX - 1; k >= 0; --k)
        if (EXACT || k < P) {
          float v = sg(P - k);  // j = 0: e_0 = 1
#pragma unroll
          for (int j = 1; j <= k; ++j) v = fmaf(sg(P - k + j), e[r][c][j - 1], v);
          e[r][c][k] = gb[r][c] * v;
        }

  // pass 2, dim by dim: recompute g_d and T; every KD dims reduce and write
  constexpr float kDuScale = 2.0f / kSqrtLog2e;  // du was staged times sqrt(log2 e)
  int buf = 0;
  for (int d0 = 0; d0 < D; d0 += kStageDims) {
    const int kd = min(kStageDims, D - d0);
    if (!staged_once) {
      __syncthreads();
      stage<BN, BM>(s_u1, s_c1, s_u2, s_c2, s_lb, u1, c1, u2, c2, logb, d0, kd,
                    row0, col0, N, M);
      __syncthreads();
    }
    for (int d1 = 0; d1 < kd; d1 += S::KD) {
      const int nd = min(S::KD, kd - d1);
      float* red = s_red + buf * S::KD * S::kRedFloats;
      float* dbs = s_db + buf * S::KD * kThreads;
      // one dim at a time: interleaving two would spill at the register cap
#pragma unroll 1
      for (int k = 0; k < nd; ++k) {
        const int d = d1 + k;
        float a[R], ca[R], b[C], cb[C];
        load_vec<R>(a, s_u1 + d * BN + ty * R);
        load_vec<R>(ca, s_c1 + d * BN + ty * R);
        load_vec<C>(b, s_u2 + d * BM + tx * C);
        load_vec<C>(cb, s_c2 + d * BM + tx * C);
        const float lb = s_lb[d];
        float rdu[R], rdc[R], cdu[C], cdc[C], db = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) rdu[r] = rdc[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) cdu[c] = cdc[c] = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float du = a[r] - b[c];
            const float bE = fast_exp2(fmaf(-du, du, lb));
            const float T = cotangent(e[r][c], fmaf(ca[r], cb[c], -bE));
            const float q = T * bE;
            rdu[r] = fmaf(q, du, rdu[r]);
            cdu[c] = fmaf(q, du, cdu[c]);
            rdc[r] = fmaf(T, cb[c], rdc[r]);
            cdc[c] = fmaf(T, ca[r], cdc[c]);
            db += q;
          }
        }
        float* rred = red + k * S::kRedFloats;
        float* cred = rred + 2 * kThreadsX * S::kRowStride;
        store_vec<R>(rred + tx * S::kRowStride + ty * R, rdu);
        store_vec<R>(rred + (kThreadsX + tx) * S::kRowStride + ty * R, rdc);
        store_vec<C>(cred + ty * S::kColStride + tx * C, cdu);
        store_vec<C>(cred + (kThreadsY + ty) * S::kColStride + tx * C, cdc);
        dbs[k * kThreads + threadIdx.x] = db;
      }
      __syncthreads();
      // each thread sums two adjacent rows' or columns' 16 partials of one
      // dim; warp k sums dim k's dlogb over the block's threads
      for (int s = threadIdx.x; s < nd * (BN + BM); s += kThreads) {
        const int k = s / (BN + BM), sk = s % (BN + BM);
        const size_t dd = d0 + d1 + k;
        const float* rred = red + k * S::kRedFloats;
        float v[2];
        if (sk < BN) {
          const int q = sk / (BN / 2), idx = 2 * (sk % (BN / 2)), i = row0 + idx;
          sum16x2(v, rred + q * kThreadsX * S::kRowStride + idx, S::kRowStride);
          const float scale = q == 0 ? -kDuScale : -1.0f;
          v[0] *= scale;
          v[1] *= scale;
          store_run<2>(rowp + (((size_t)q * blocks_m + tile_j) * D + dd) * N + i, v, N - i,
                       N % 2 == 0);
        } else {
          const int q = (sk - BN) / (BM / 2), idx = 2 * ((sk - BN) % (BM / 2));
          const int j = col0 + idx;
          const float* cred = rred + 2 * kThreadsX * S::kRowStride;
          sum16x2(v, cred + q * kThreadsY * S::kColStride + idx, S::kColStride);
          const float scale = q == 0 ? kDuScale : -1.0f;
          v[0] *= scale;
          v[1] *= scale;
          store_run<2>(colp + (((size_t)q * blocks_n + tile_i) * D + dd) * M + j, v, M - j,
                       M % 2 == 0);
        }
      }
      if (warp < nd) {
        float v = 0.0f;
#pragma unroll
        for (int t = 0; t < kThreads; t += 32) v += dbs[warp * kThreads + t + lane];
        v = warp_sum(v);
        if (lane == 0) dlogbp[(size_t)blockIdx.x * D + d0 + d1 + warp] = v;
      }
      buf ^= 1;
    }
  }

  // the extra grams: no reduction, one cotangent per element
  if (dextra != nullptr) {
    for (int k = 0; k < E; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + ty * R + r;
        const int n = i < N ? M - j0 : 0;
        const size_t at = k * nm + (size_t)i * M + j0;
        float x[C], dx[C];
        load_run<C>(x, extra + at, n, vec);
#pragma unroll
        for (int c = 0; c < C; ++c) dx[c] = cotangent(e[r][c], -x[c]);
        store_run<C>(dextra + at, dx, n, vec);
      }
    }
  }
}

// Threads that share one output of oak_gram_bwd_reduce: more where the
// outputs are few and the planes many (du1, dc1 at Kuf: 32 K outputs of
// 128 planes get 8), until about 256 K threads keep memory busy.
__host__ __device__ int plane_groups(int planes, size_t outputs) {
  int g = 1;
  while (g < 8 && 4 * g <= planes && outputs * g < (size_t)1 << 18) g *= 2;
  return g;
}

// Sums `planes` planes of `len` floats, two quantities one after the other
// (quantity q's planes start at src + q * planes * len), into out0 and out1.
// `groups` threads share an output: group g sums planes g, g + groups, ...,
// and the groups' sums are added in the order of g, so the order is fixed.
__device__ __forceinline__ void sum_planes(const float* __restrict__ src, int planes,
                                           size_t len, float* __restrict__ out0,
                                           float* __restrict__ out1, int groups,
                                           int block, float* s_part) {
  const int per_block = kThreads / groups;
  const int g = threadIdx.x / per_block, o = threadIdx.x % per_block;
  const size_t t = (size_t)block * per_block + o;
  const size_t q = t / len, at = t - q * len;
  float v = 0.0f;
  if (t < 2 * len) {
    const float* p = src + q * planes * len + at;
    for (int b = g; b < planes; b += groups) v += p[b * len];
  }
  s_part[threadIdx.x] = v;
  __syncthreads();
  if (g == 0 && t < 2 * len) {
    float sum = 0.0f;
    for (int k = 0; k < groups; ++k) sum += s_part[k * per_block + o];
    (q == 0 ? out0 : out1)[at] = sum;
  }
}

// Sums the per-tile partials in a fixed order: du1, dc1 over the column
// tiles in the first row_blocks blocks, du2, dc2 over the row tiles in the
// next col_blocks, then one block per dlogb[d] and per dsig2[n], each a
// fixed tree over all tiles.
__global__ void __launch_bounds__(kThreads)
oak_gram_bwd_reduce(const float* __restrict__ work, Workspace w,
                    float* __restrict__ du1, float* __restrict__ dc1,
                    float* __restrict__ du2, float* __restrict__ dc2,
                    float* __restrict__ dlogb, float* __restrict__ dsig2,
                    int D, int N, int M, int P, int blocks_n, int blocks_m,
                    int row_blocks, int col_blocks) {
  __shared__ float s_part[kThreads];
  const int b = blockIdx.x;
  if (b < row_blocks) {
    sum_planes(work + w.rowp, blocks_m, (size_t)D * N, du1, dc1,
               plane_groups(blocks_m, 2 * (size_t)D * N), b, s_part);
    return;
  }
  if (b < row_blocks + col_blocks) {
    sum_planes(work + w.colp, blocks_n, (size_t)D * M, du2, dc2,
               plane_groups(blocks_n, 2 * (size_t)D * M), b - row_blocks, s_part);
    return;
  }
  const int k = b - row_blocks - col_blocks;
  const int blocks = blocks_n * blocks_m;
  const bool is_logb = k < D;
  const float* src = work + (is_logb ? w.dlogbp + k : w.dsig2p + (k - D));
  const int stride = is_logb ? D : P + 1;
  float v = 0.0f;
  for (int t = threadIdx.x; t < blocks; t += kThreads) v += src[(size_t)t * stride];
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) s_part[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += s_part[i];
    if (is_logb) dlogb[k] = sum;
    else dsig2[k - D] = sum;
  }
}

template <int PMAX, int V>
void grid_of(int N, int M, int* blocks_n, int* blocks_m) {
  constexpr int BN = kThreadsY * bwd_rows(PMAX, V), BM = kThreadsX * bwd_cols(PMAX, V);
  *blocks_n = (N + BN - 1) / BN;
  *blocks_m = (M + BM - 1) / BM;
}

template <int PMAX, int V>
cudaError_t launch(const float* u1, const float* u2, const float* c1,
                   const float* c2, const float* extra, const float* logb,
                   const float* sig2, const float* gbar, float* work,
                   float* du1, float* dc1, float* du2, float* dc2,
                   float* dlogb, float* dsig2, float* dextra, int D, int N,
                   int M, int E, int P, cudaStream_t stream) {
  constexpr int R = bwd_rows(PMAX, V), C = bwd_cols(PMAX, V);
  using S = BwdShape<PMAX, R, C>;
  int blocks_n, blocks_m;
  grid_of<PMAX, V>(N, M, &blocks_n, &blocks_m);
  const Workspace w = workspace(D, N, M, P, blocks_n, blocks_m);
  auto kernel = oak_gram_bwd_kernel<PMAX, R, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks_n * (unsigned)blocks_m, kThreads, S::kSmemBytes,
           stream>>>(u1, u2, c1, c2, extra, logb, sig2, gbar, work + w.rowp,
                     work + w.colp, work + w.dlogbp, work + w.dsig2p, dextra,
                     D, N, M, E, P, blocks_n, blocks_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_row = kThreads / plane_groups(blocks_m, 2 * (size_t)D * N);
  const int per_col = kThreads / plane_groups(blocks_n, 2 * (size_t)D * M);
  const int row_blocks = (int)((2 * (size_t)D * N + per_row - 1) / per_row);
  const int col_blocks = (int)((2 * (size_t)D * M + per_col - 1) / per_col);
  oak_gram_bwd_reduce<<<row_blocks + col_blocks + D + P + 1, kThreads, 0, stream>>>(
      work, w, du1, dc1, du2, dc2, dlogb, dsig2, D, N, M, P, blocks_n, blocks_m,
      row_blocks, col_blocks);
  return cudaGetLastError();
}

template <int PMAX, int V>
long long workspace_floats(int D, int N, int M, int P) {
  int blocks_n, blocks_m;
  grid_of<PMAX, V>(N, M, &blocks_n, &blocks_m);
  return (long long)workspace(D, N, M, P, blocks_n, blocks_m).total;
}

bool valid(int P, int variant) {
  return P >= 1 && P <= kMaxDepth && variant >= 0 && variant <= 1;
}

}  // namespace

#define OAK_BWD_DISPATCH(call)                                                 \
  switch (depth_bucket(P)) {                                                   \
    case 1: return variant ? call(1, 1) : call(1, 0);                          \
    case 2: return variant ? call(2, 1) : call(2, 0);                          \
    case 3: return variant ? call(3, 1) : call(3, 0);                          \
    case 4: return variant ? call(4, 1) : call(4, 0);                          \
    case 5: return variant ? call(5, 1) : call(5, 0);                          \
    case 6: return variant ? call(6, 1) : call(6, 0);                          \
    case 7: return variant ? call(7, 1) : call(7, 0);                          \
    case 8: return variant ? call(8, 1) : call(8, 0);                          \
    case 16: return call(16, 0);                                               \
    case 32: return call(32, 0);                                               \
    default: return call(64, 0);                                               \
  }

// The block tile (rows bn x columns bm) the backward kernel takes at clamped
// depth P for variant 0 (large) or 1 (small). Returns a cudaError_t.
extern "C" int oak_gram_bwd_tile(int P, int variant, int* bn, int* bm) {
  if (!valid(P, variant)) return (int)cudaErrorInvalidValue;
  const int pmax = depth_bucket(P);
  *bn = kThreadsY * bwd_rows(pmax, variant);
  *bm = kThreadsX * bwd_cols(pmax, variant);
  return 0;
}

// Floats of workspace oak_gram_bwd_f32 needs for these sizes (the per-tile
// partials); -1 for an invalid depth or variant.
extern "C" long long oak_gram_bwd_workspace(int D, int N, int M, int P,
                                            int variant) {
  if (!valid(P, variant)) return -1;
#define OAK_WS(pmax, v) workspace_floats<pmax, v>(D, N, M, P)
  OAK_BWD_DISPATCH(OAK_WS)
#undef OAK_WS
}

// Returns the cudaError_t of the launches (0 on success): the tile kernel,
// then oak_gram_bwd_reduce. P is the clamped depth, 1..64; dsig2 gets P + 1
// entries. work holds oak_gram_bwd_workspace(D, N, M, P, variant) floats.
// dextra may be null: the extra grams' cotangent is then not written.
extern "C" int oak_gram_bwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, const float* gbar,
                                float* work, float* du1, float* dc1,
                                float* du2, float* dc2, float* dlogb,
                                float* dsig2, float* dextra, int D, int N,
                                int M, int E, int P, int variant,
                                void* stream) {
  if (!valid(P, variant)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OAK_LAUNCH(pmax, v)                                                    \
  (int)launch<pmax, v>(u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1,    \
                       dc1, du2, dc2, dlogb, dsig2, dextra, D, N, M, E, P, s)
  OAK_BWD_DISPATCH(OAK_LAUNCH)
#undef OAK_LAUNCH
}
#undef OAK_BWD_DISPATCH
