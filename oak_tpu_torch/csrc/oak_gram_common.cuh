// Shared by the fused OAK gram kernels (oak_gram_fwd.cu, oak_gram_bwd.cu):
// the block shape, the micro-tile each kernel takes at each depth, the
// staging of the prescaled inputs into shared memory, the fast exp, and the
// update of the elementary symmetric polynomials.
//
// Both kernels take the per-dim grams
//
//   g_d = exp(logb[d] - (u1[d,i] - u2[d,j])^2) - c1[d,i] c2[d,j]
//
// and form e_1..e_P of them by the product expansion prod_d (1 + g_d t):
// e_k += g e_{k-1} for k = P..1, one FFMA per order. This is the same
// polynomial as oak_tpu's power sums plus Newton-Girard, costs P operations
// per (element, dim) where the power sums cost about 2P - 2, and does not
// cancel: after d grams e_k is exactly 0 for k > d, so the wrappers clamp
// the depth to the number of grams.
//
// Staging multiplies u by sqrt(log2 e) and logb by log2 e, so that
// exp(logb - du^2) = exp2(logb' - du'^2): one FADD (du'), one FFMA (the
// exponent) and one MUFU ex2.approx.ftz per (element, dim).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace oak {

constexpr int kThreadsX = 16;  // threads along M (columns)
constexpr int kThreadsY = 16;  // threads along N (rows)
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;
constexpr int kStageDims = 32;  // dims staged into shared memory at a time
constexpr int kMaxDepth = 64;   // deepest (clamped) depth any variant takes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrtLog2e = 1.2011224087864498f;

// The lane axis: one launch computes the gram of L independent sets of
// inputs (the lanes of a multistart, as jax.vmap prepends a grid axis to a
// pallas_call), lane l on the blocks whose blockIdx.y is l. Each input's
// lane stride is the number of elements from one lane's slice to the next's,
// 0 for an input that every lane shares; outputs are dense [L, ...].
struct LaneStrides {
  long long u1, u2, c1, c2, extra, logb, sig2, gbar;
};

// The strides from the entry point's array (n of them, in the order of the
// struct; gbar 0 when n is 7); false when one is negative.
inline bool read_lanes(LaneStrides* s, const long long* src, int n) {
  long long v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < n; ++k) {
    if (src[k] < 0) return false;
    v[k] = src[k];
  }
  *s = LaneStrides{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  return true;
}

// Depth bucket: exact templates for P <= 8 keep e_1..e_P in registers with
// compile-time indices; above 8 one variant per bucket takes a runtime P.
constexpr int depth_bucket(int P) {
  return P <= 8 ? P : P <= 16 ? 16 : P <= 32 ? 32 : 64;
}

// Micro-tiles, rows x columns of outputs per thread. Variant 0 is the large
// tile, variant 1 the small one for grids that would not cover the card.
// The tiles shrink with depth so that e_1..e_P of every output stay in
// registers without spilling.
constexpr int fwd_rows(int pmax, int variant) {
  return pmax <= 8 ? (variant ? 2 : 4) : pmax <= 16 ? 2 : 1;
}
constexpr int fwd_cols(int pmax, int variant) {
  return pmax <= 8 ? (variant ? 2 : 4) : pmax <= 32 ? 2 : 1;
}
constexpr int bwd_rows(int pmax, int variant) {
  return pmax <= 4 ? (variant ? 2 : 4) : pmax <= 16 ? 2 : 1;
}
constexpr int bwd_cols(int pmax, int variant) {
  return pmax <= 4 ? (variant ? 2 : 4) : pmax <= 32 ? 2 : 1;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <int K>
__device__ __forceinline__ bool aligned_for(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % (K * sizeof(float))) == 0;
}

// v[0..K) = p[0..K) in one vector access (p aligned to K floats).
template <int K>
__device__ __forceinline__ void load_vec(float (&v)[K], const float* p) {
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// A run of K floats of a row of an [N, M] array that holds n of them (n < K
// at the ragged edge, n <= 0 past it): one vector access when the run is
// whole and `vec` says rows are aligned, else masked scalar accesses.
template <int K>
__device__ __forceinline__ void load_run(float (&v)[K], const float* p, int n,
                                         bool vec) {
  if (vec && n >= K) {
    load_vec<K>(v, p);
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = k < n ? p[k] : 0.0f;
}

template <int K>
__device__ __forceinline__ void store_run(float* p, const float (&v)[K], int n,
                                          bool vec) {
  if (vec && n >= K) {
    store_vec<K>(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) p[k] = v[k];
}

// e[k - 1] holds e_k. Adds one gram g: e_k += g e_{k-1} for k = P..1 (e_0 =
// 1). With EXACT, P == PMAX at compile time; otherwise the orders above the
// runtime P are skipped.
template <int PMAX, bool EXACT>
__device__ __forceinline__ void add_gram(float (&e)[PMAX], float g, int P) {
#pragma unroll
  for (int k = PMAX - 1; k >= 1; --k)
    if (EXACT || k < P) e[k] = fmaf(g, e[k - 1], e[k]);
  e[0] += g;
}

// Stages dims [d0, d0 + kd) of the block's BN rows (u1, c1) and BM columns
// (u2, c2) into shared memory as s[d * BN + r], prescaled for exp2; rows and
// columns outside the gram are staged as 0. Loads are coalesced along rows.
template <int BN, int BM>
__device__ __forceinline__ void stage(float* s_u1, float* s_c1, float* s_u2,
                                      float* s_c2, float* s_lb,
                                      const float* __restrict__ u1,
                                      const float* __restrict__ c1,
                                      const float* __restrict__ u2,
                                      const float* __restrict__ c2,
                                      const float* __restrict__ logb, int d0,
                                      int kd, int row0, int col0, int N,
                                      int M) {
  for (int idx = threadIdx.x; idx < kd * BN; idx += kThreads) {
    const int d = idx / BN, i = row0 + idx % BN;
    const size_t at = (size_t)(d0 + d) * N + i;
    s_u1[idx] = i < N ? u1[at] * kSqrtLog2e : 0.0f;
    s_c1[idx] = i < N ? c1[at] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < kd * BM; idx += kThreads) {
    const int d = idx / BM, j = col0 + idx % BM;
    const size_t at = (size_t)(d0 + d) * M + j;
    s_u2[idx] = j < M ? u2[at] * kSqrtLog2e : 0.0f;
    s_c2[idx] = j < M ? c2[at] : 0.0f;
  }
  for (int d = threadIdx.x; d < kd; d += kThreads) s_lb[d] = logb[d0 + d] * kLog2e;
}

}  // namespace oak
