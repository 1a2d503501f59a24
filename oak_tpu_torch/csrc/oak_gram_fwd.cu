// Fused OAK gram forward for Hopper (sm_90a).
//
// Replaces the TPU kernel oak_tpu/ops/oak_gram_pallas.py::_gram_kernel
// (launched by _pallas_gram). For every output element (i, j) it computes
//
//   g_d   = exp(logb[d] - (u1[d,i] - u2[d,j])^2) - c1[d,i] * c2[d,j]   d < D
//   g_D+e = extra[e, i, j]                                             e < E
//   e_n   = the elementary symmetric polynomials of the g, n = 1..P
//   out   = sig2[0] + sum_{n=1..P} sig2[n] e_n
//
// on inputs prescaled by oak_tpu_torch/ops/oak_gram.py::_prep. Layouts, all
// float32 and contiguous: u1, c1 [D, N]; u2, c2 [D, M]; extra [E, N, M];
// logb [D]; sig2 [P + 1]; out [N, M]. P is the clamped depth, 1..64.
//
// What bounds it on this card: per (element, dim) one MUFU ex2 and 3 + P
// FP32 operations (oak_gram_common.cuh), while only O((N + M) D + (E + 1)
// N M) bytes move. An SM runs 16 ex2 but 128 FP32 lanes a clock, so at
// depth <= 4 the exps bound it (Kus, 512 x 8192 at D = 32: 134 M exps, 32 us
// at 1.98 GHz), deeper the FP32 lanes.
//
// Design: a block of 16 x 16 threads owns a tile of 16R x 16C outputs, each
// thread a register micro-tile of R rows x C columns (4 x 4 at depth <= 8,
// smaller for small grids and deeper variants; oak_gram_common.cuh) with
// e_1..e_P of every output in registers; at depth <= 2 three blocks share
// an SM (80 registers), which hides the staging of short dim loops (the
// square gram's D = 8). The block stages its rows' and
// columns' u, c (32 dims at a time) into shared memory, prescaled for exp2,
// so a thread reads its R + R + C + C values per dim as vector broadcasts:
// 4 LDS.128 per 16 (element, dim) at 4 x 4, and the inner loop is FP32 and
// MUFU only. The E extra grams stream from global memory, coalesced along
// rows. Stores are float4 along rows where aligned, masked at ragged edges.
// A square gram (u2, c2 copies of u1, c1) comes out exactly symmetric: (i, j)
// and (j, i) run the same operations on the same bits.

#include "oak_gram_common.cuh"

namespace {

using namespace oak;

template <int PMAX, int R, int C>
__global__ void __launch_bounds__(kThreads, R * C * PMAX <= 32 ? 3 : R * C * PMAX <= 64 ? 2 : 1)
oak_gram_fwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                    const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ extra,
                    const float* __restrict__ logb,
                    const float* __restrict__ sig2, float* __restrict__ out,
                    int D, int N, int M, int E, int P_arg, int blocks_m) {
  constexpr bool EXACT = PMAX <= 8;
  constexpr int BN = kThreadsY * R, BM = kThreadsX * C;
  const int P = EXACT ? PMAX : P_arg;
  __shared__ __align__(16) float s_u1[kStageDims * BN];
  __shared__ __align__(16) float s_c1[kStageDims * BN];
  __shared__ __align__(16) float s_u2[kStageDims * BM];
  __shared__ __align__(16) float s_c2[kStageDims * BM];
  __shared__ float s_lb[kStageDims];

  const int tile_i = blockIdx.x / blocks_m;
  const int tile_j = blockIdx.x - tile_i * blocks_m;
  const int row0 = tile_i * BN, col0 = tile_j * BM;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  const int j0 = col0 + tx * C;  // the thread's first column
  const bool vec = M % C == 0 && aligned_for<C>(out) &&
                   (E == 0 || aligned_for<C>(extra));

  float e[R][C][PMAX];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < PMAX; ++k) e[r][c][k] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kStageDims) {
    const int kd = min(kStageDims, D - d0);
    __syncthreads();
    stage<BN, BM>(s_u1, s_c1, s_u2, s_c2, s_lb, u1, c1, u2, c2, logb, d0, kd,
                  row0, col0, N, M);
    __syncthreads();
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

  const size_t nm = (size_t)N * M;
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

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + ty * R + r;
    if (i >= N) break;
    float o[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[c] = sig2[0];
#pragma unroll
      for (int n = 1; n <= PMAX; ++n)
        if (EXACT || n <= P) o[c] = fmaf(sig2[n], e[r][c][n - 1], o[c]);
    }
    store_run<C>(out + (size_t)i * M + j0, o, M - j0, vec);
  }
}

template <int PMAX, int V>
cudaError_t launch(const float* u1, const float* u2, const float* c1,
                   const float* c2, const float* extra, const float* logb,
                   const float* sig2, float* out, int D, int N, int M, int E,
                   int P, cudaStream_t stream) {
  constexpr int R = fwd_rows(PMAX, V), C = fwd_cols(PMAX, V);
  const int blocks_m = (M + kThreadsX * C - 1) / (kThreadsX * C);
  const int blocks_n = (N + kThreadsY * R - 1) / (kThreadsY * R);
  oak_gram_fwd_kernel<PMAX, R, C><<<(unsigned)blocks_m * (unsigned)blocks_n,
                                    kThreads, 0, stream>>>(
      u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, P, blocks_m);
  return cudaGetLastError();
}

}  // namespace

// The block tile (rows bn x columns bm) the forward kernel takes at clamped
// depth P for variant 0 (large) or 1 (small). Returns a cudaError_t.
extern "C" int oak_gram_fwd_tile(int P, int variant, int* bn, int* bm) {
  if (P < 1 || P > kMaxDepth || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int pmax = depth_bucket(P);
  *bn = kThreadsY * fwd_rows(pmax, variant);
  *bm = kThreadsX * fwd_cols(pmax, variant);
  return 0;
}

// Returns the cudaError_t of the launch (0 on success). P is the clamped
// depth, 1..64 (ops/oak_gram.py passes min(depth, D + E)); variant as in
// oak_gram_fwd_tile.
extern "C" int oak_gram_fwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, float* out, int D, int N,
                                int M, int E, int P, int variant,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OAK_FWD(pmax)                                                          \
  (variant ? launch<pmax, 1>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, \
                             E, P, s)                                          \
           : launch<pmax, 0>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, \
                             E, P, s))
  if (P < 1 || P > kMaxDepth || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  switch (depth_bucket(P)) {
    case 1: return (int)OAK_FWD(1);
    case 2: return (int)OAK_FWD(2);
    case 3: return (int)OAK_FWD(3);
    case 4: return (int)OAK_FWD(4);
    case 5: return (int)OAK_FWD(5);
    case 6: return (int)OAK_FWD(6);
    case 7: return (int)OAK_FWD(7);
    case 8: return (int)OAK_FWD(8);
    case 16: return (int)OAK_FWD(16);
    case 32: return (int)OAK_FWD(32);
    default: return (int)OAK_FWD(64);
  }
#undef OAK_FWD
}
