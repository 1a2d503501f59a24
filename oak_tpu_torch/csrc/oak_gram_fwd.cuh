// The forward kernel of oak_gram_fwd.cu (see there), its launch and the
// dispatch over depth buckets and tile variants, as templates on LANES: the
// one-lane launch (LANES false) is instantiated in oak_gram_fwd.cu, the
// lane-batched one (true) in oak_gram_fwd_lanes.cu, so that each compiles in
// its own nvcc process and the one-lane kernels keep their registers.

#pragma once

#include "oak_gram_common.cuh"

namespace oak {
namespace {

template <int PMAX, int R, int C, bool LANES>
__global__ void __launch_bounds__(kThreads, R * C * PMAX <= 32 ? 3 : R * C * PMAX <= 64 ? 2 : 1)
oak_gram_fwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                    const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ extra,
                    const float* __restrict__ logb,
                    const float* __restrict__ sig2, float* __restrict__ out,
                    int D, int N, int M, int E, int P_arg, int blocks_m,
                    LaneStrides lanes) {
  constexpr bool EXACT = PMAX <= 8;
  constexpr int BN = kThreadsY * R, BM = kThreadsX * C;
  const int P = EXACT ? PMAX : P_arg;
  __shared__ __align__(16) float s_u1[kStageDims * BN];
  __shared__ __align__(16) float s_c1[kStageDims * BN];
  __shared__ __align__(16) float s_u2[kStageDims * BM];
  __shared__ __align__(16) float s_c2[kStageDims * BM];
  __shared__ float s_lb[kStageDims];

  if constexpr (LANES) {
    const long long lane = blockIdx.y;
    u1 += lane * lanes.u1;
    u2 += lane * lanes.u2;
    c1 += lane * lanes.c1;
    c2 += lane * lanes.c2;
    extra += lane * lanes.extra;
    logb += lane * lanes.logb;
    sig2 += lane * lanes.sig2;
    out += lane * N * (long long)M;
  }
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

template <int PMAX, int V, bool LANES>
cudaError_t launch(const float* u1, const float* u2, const float* c1,
                   const float* c2, const float* extra, const float* logb,
                   const float* sig2, float* out, int D, int N, int M, int E,
                   int P, int L, const LaneStrides& lanes, cudaStream_t stream) {
  constexpr int R = fwd_rows(PMAX, V), C = fwd_cols(PMAX, V);
  const int blocks_m = (M + kThreadsX * C - 1) / (kThreadsX * C);
  const int blocks_n = (N + kThreadsY * R - 1) / (kThreadsY * R);
  const dim3 grid((unsigned)blocks_m * (unsigned)blocks_n, (unsigned)L);
  oak_gram_fwd_kernel<PMAX, R, C, LANES><<<grid, kThreads, 0, stream>>>(
      u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, P, blocks_m, lanes);
  return cudaGetLastError();
}

// Launches the variant of clamped depth P (1..64) and tile variant (0, 1),
// already validated, for L lanes (LANES) or one.
template <bool LANES>
cudaError_t gram_fwd(const float* u1, const float* u2, const float* c1, const float* c2,
                     const float* extra, const float* logb, const float* sig2, float* out,
                     int D, int N, int M, int E, int P, int variant, int L,
                     const LaneStrides& lanes, cudaStream_t s) {
#define OAK_FWD(pmax)                                                                 \
  (variant ? launch<pmax, 1, LANES>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, \
                                    E, P, L, lanes, s)                                \
           : launch<pmax, 0, LANES>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, \
                                    E, P, L, lanes, s))
  switch (depth_bucket(P)) {
    case 1: return OAK_FWD(1);
    case 2: return OAK_FWD(2);
    case 3: return OAK_FWD(3);
    case 4: return OAK_FWD(4);
    case 5: return OAK_FWD(5);
    case 6: return OAK_FWD(6);
    case 7: return OAK_FWD(7);
    case 8: return OAK_FWD(8);
    case 16: return OAK_FWD(16);
    case 32: return OAK_FWD(32);
    default: return OAK_FWD(64);
  }
#undef OAK_FWD
}

}  // namespace

// gram_fwd<true>, compiled in oak_gram_fwd_lanes.cu.
cudaError_t gram_fwd_lanes(const float* u1, const float* u2, const float* c1,
                           const float* c2, const float* extra, const float* logb,
                           const float* sig2, float* out, int D, int N, int M, int E, int P,
                           int variant, int L, const LaneStrides& lanes, cudaStream_t s);

}  // namespace oak
