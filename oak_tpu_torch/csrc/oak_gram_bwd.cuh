// The backward kernels of oak_gram_bwd.cu (see there), their launch and the
// dispatch over depth buckets and tile variants, as templates on LANES: the
// one-lane launch (LANES false) is instantiated in oak_gram_bwd.cu, the
// lane-batched one (true) in oak_gram_bwd_lanes.cu, so that each compiles in
// its own nvcc process and the one-lane kernels keep their registers.

#pragma once

#include "oak_gram_common.cuh"

namespace oak {
namespace {

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
  // a lane's share rounded up to 4 floats, so that every lane's partials
  // start 16-byte aligned: the row and column partials take 8-byte stores
  // and loads, which an odd total misaligned in lanes 1, 3, ...
  w.total = (w.dsig2p + blocks * (P + 1) + 3) & ~(size_t)3;
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

// Lane blockIdx.y's slice of p, at `stride` elements a lane (LANES), or p.
template <bool LANES, typename T>
__device__ __forceinline__ T* lane_slice(T* p, long long stride) {
  if constexpr (LANES) return p + (long long)blockIdx.y * stride;
  else return p;
}

// The same, with the lane read afresh (volatile, so that the compiler
// neither merges nor hoists it), for the pointers pass 2 uses: held from the
// kernel's entry they stay live in registers through pass 2, where the
// one-lane kernel reads its pointers from the parameter bank, and made the
// 4 x 4 tile at depth 3 spill 40 bytes (8 remain: the counter of pass 2's
// loop over staged dims, stored and loaded once per 32 dims).
template <bool LANES, typename T>
__device__ __forceinline__ T* lane_ptr(T* p, long long stride) {
  if constexpr (LANES) {
    unsigned l;
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(l));
    return p + (long long)l * stride;
  } else {
    return p;
  }
}

template <int PMAX, int R, int C, bool LANES>
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
                    int blocks_m, LaneStrides lanes, long long work_lane) {
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

  const size_t nm = (size_t)N * M;
  // This lane's slices: pass 1 offsets its own once (they die with it);
  // pass 2 and the extra grams' cotangent offset theirs at each use.
  const float* const gbar1 = lane_slice<LANES>(gbar, lanes.gbar);
  const float* const sig21 = lane_slice<LANES>(sig2, lanes.sig2);
  const float* const extra1 = lane_slice<LANES>(extra, lanes.extra);
  float* const dsig2p1 = lane_slice<LANES>(dsig2p, work_lane);
  auto in = [&](const float* p, long long stride) { return lane_ptr<LANES>(p, stride); };
  auto out = [&](float* p) { return lane_ptr<LANES>(p, work_lane); };
  const int tile_i = blockIdx.x / blocks_m;
  const int tile_j = blockIdx.x - tile_i * blocks_m;
  const int row0 = tile_i * BN, col0 = tile_j * BM;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = col0 + tx * C;
  const bool vec = M % C == 0 && aligned_for<C>(gbar1) &&
                   (E == 0 || (aligned_for<C>(extra1) &&
                               (dextra == nullptr ||
                                aligned_for<C>(lane_slice<LANES>(dextra, (long long)E * nm)))));

  for (int n = threadIdx.x; n <= P; n += kThreads) s_sg[n] = sig21[n];
  // sig2 in registers for the exact depths, from shared memory deeper
  float sg_r[EXACT ? PMAX + 1 : 1];
  if constexpr (EXACT) {
#pragma unroll
    for (int n = 0; n <= PMAX; ++n) sg_r[n] = sig21[n];
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
    stage<BN, BM>(s_u1, s_c1, s_u2, s_c2, s_lb, lane_slice<LANES>(u1, lanes.u1),
                  lane_slice<LANES>(c1, lanes.c1), lane_slice<LANES>(u2, lanes.u2),
                  lane_slice<LANES>(c2, lanes.c2), lane_slice<LANES>(logb, lanes.logb),
                  d0, kd, row0, col0, N, M);
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
      load_run<C>(x, extra1 + k * nm + (size_t)i * M + j0, i < N ? M - j0 : 0, vec);
#pragma unroll
      for (int c = 0; c < C; ++c) add_gram<PMAX, EXACT>(e[r][c], x[c], P);
    }
  }
  float gb[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty * R + r;
    load_run<C>(gb[r], gbar1 + (size_t)i * M + j0, i < N ? M - j0 : 0, vec);
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
    dsig2p1[(size_t)blockIdx.x * (P + 1) + n] = v;
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
      stage<BN, BM>(s_u1, s_c1, s_u2, s_c2, s_lb, in(u1, lanes.u1), in(c1, lanes.c1),
                    in(u2, lanes.u2), in(c2, lanes.c2), in(logb, lanes.logb), d0, kd,
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
      float* const rowp_l = out(rowp);  // this lane's, live only here
      float* const colp_l = out(colp);
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
          store_run<2>(rowp_l + (((size_t)q * blocks_m + tile_j) * D + dd) * N + i, v,
                       N - i, N % 2 == 0);
        } else {
          const int q = (sk - BN) / (BM / 2), idx = 2 * ((sk - BN) % (BM / 2));
          const int j = col0 + idx;
          const float* cred = rred + 2 * kThreadsX * S::kRowStride;
          sum16x2(v, cred + q * kThreadsY * S::kColStride + idx, S::kColStride);
          const float scale = q == 0 ? kDuScale : -1.0f;
          v[0] *= scale;
          v[1] *= scale;
          store_run<2>(colp_l + (((size_t)q * blocks_n + tile_i) * D + dd) * M + j, v,
                       M - j, M % 2 == 0);
        }
      }
      if (warp < nd) {
        float v = 0.0f;
#pragma unroll
        for (int t = 0; t < kThreads; t += 32) v += dbs[warp * kThreads + t + lane];
        v = warp_sum(v);
        if (lane == 0) out(dlogbp)[(size_t)blockIdx.x * D + d0 + d1 + warp] = v;
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
        load_run<C>(x, in(extra, lanes.extra) + at, n, vec);
#pragma unroll
        for (int c = 0; c < C; ++c) dx[c] = cotangent(e[r][c], -x[c]);
        store_run<C>(lane_ptr<LANES>(dextra, (long long)E * nm) + at, dx, n, vec);
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
// fixed tree over all tiles; lane blockIdx.y's partials into its outputs.
__global__ void __launch_bounds__(kThreads)
oak_gram_bwd_reduce(const float* __restrict__ work, Workspace w,
                    float* __restrict__ du1, float* __restrict__ dc1,
                    float* __restrict__ du2, float* __restrict__ dc2,
                    float* __restrict__ dlogb, float* __restrict__ dsig2,
                    int D, int N, int M, int P, int blocks_n, int blocks_m,
                    int row_blocks, int col_blocks) {
  __shared__ float s_part[kThreads];
  const int b = blockIdx.x;
  {
    const long long l = blockIdx.y;
    work += l * (long long)w.total;
    du1 += l * D * (long long)N;
    dc1 += l * D * (long long)N;
    du2 += l * D * (long long)M;
    dc2 += l * D * (long long)M;
    dlogb += l * D;
    dsig2 += l * (P + 1);
  }
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

template <int PMAX, int V, bool LANES>
cudaError_t launch(const float* u1, const float* u2, const float* c1,
                   const float* c2, const float* extra, const float* logb,
                   const float* sig2, const float* gbar, float* work,
                   float* du1, float* dc1, float* du2, float* dc2,
                   float* dlogb, float* dsig2, float* dextra, int D, int N,
                   int M, int E, int P, int L, const LaneStrides& lanes,
                   cudaStream_t stream) {
  constexpr int R = bwd_rows(PMAX, V), C = bwd_cols(PMAX, V);
  using S = BwdShape<PMAX, R, C>;
  int blocks_n, blocks_m;
  grid_of<PMAX, V>(N, M, &blocks_n, &blocks_m);
  const Workspace w = workspace(D, N, M, P, blocks_n, blocks_m);
  auto kernel = oak_gram_bwd_kernel<PMAX, R, C, LANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks_n * (unsigned)blocks_m, (unsigned)L);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      u1, u2, c1, c2, extra, logb, sig2, gbar, work + w.rowp, work + w.colp,
      work + w.dlogbp, work + w.dsig2p, dextra, D, N, M, E, P, blocks_n, blocks_m,
      lanes, (long long)w.total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_row = kThreads / plane_groups(blocks_m, 2 * (size_t)D * N);
  const int per_col = kThreads / plane_groups(blocks_n, 2 * (size_t)D * M);
  const int row_blocks = (int)((2 * (size_t)D * N + per_row - 1) / per_row);
  const int col_blocks = (int)((2 * (size_t)D * M + per_col - 1) / per_col);
  const dim3 reduce_grid((unsigned)(row_blocks + col_blocks + D + P + 1), (unsigned)L);
  oak_gram_bwd_reduce<<<reduce_grid, kThreads, 0, stream>>>(
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

// Launches the variant of clamped depth P (1..64) and tile variant (0, 1),
// already validated, for L lanes (LANES) or one.
template <bool LANES>
cudaError_t gram_bwd(const float* u1, const float* u2, const float* c1, const float* c2,
                     const float* extra, const float* logb, const float* sig2,
                     const float* gbar, float* work, float* du1, float* dc1, float* du2,
                     float* dc2, float* dlogb, float* dsig2, float* dextra, int D, int N,
                     int M, int E, int P, int variant, int L, const LaneStrides& lanes,
                     cudaStream_t s) {
#define OAK_LAUNCH(pmax, v)                                                    \
  launch<pmax, v, LANES>(u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1,  \
                         dc1, du2, dc2, dlogb, dsig2, dextra, D, N, M, E, P,  \
                         L, lanes, s)
  OAK_BWD_DISPATCH(OAK_LAUNCH)
#undef OAK_LAUNCH
}

}  // namespace

// gram_bwd<true>, compiled in oak_gram_bwd_lanes.cu.
cudaError_t gram_bwd_lanes(const float* u1, const float* u2, const float* c1,
                           const float* c2, const float* extra, const float* logb,
                           const float* sig2, const float* gbar, float* work, float* du1,
                           float* dc1, float* du2, float* dc2, float* dlogb, float* dsig2,
                           float* dextra, int D, int N, int M, int E, int P, int variant,
                           int L, const LaneStrides& lanes, cudaStream_t s);

}  // namespace oak
