// Fused OAK gram forward for Hopper (sm_90a).
//
// Replaces the TPU kernel oak_tpu/ops/oak_gram_pallas.py::_gram_kernel
// (launched by _pallas_gram). For every output element (i, j) it computes
//
//   g_d   = exp(logb[d] - (u1[d,i] - u2[d,j])^2) - c1[d,i] * c2[d,j]   d < D
//   g_D+e = extra[e, i, j]                                             e < E
//   s_p   = sum_d g_d^p                                                p = 1..P
//   e_n   = (1/n) sum_{k=1..n} (-1)^(k-1) e_{n-k} s_k                  (Newton-Girard)
//   out   = sum_{n=0..P} sig2[n] e_n
//
// on inputs prescaled by oak_tpu_torch/ops/oak_gram.py::_prep. Layouts, all
// float32 and contiguous: u1, c1 [D, N]; u2, c2 [D, M]; extra [E, N, M];
// logb [D]; sig2 [P + 1]; out [N, M].
//
// What bounds it on this card: per output element about D exps (SFU) and
// about 6D FMAs, while only O((N + M) D + (E + 1) N M) bytes move (the u/c
// slivers are reused by a whole block row or column out of L1/L2). At the
// predict shape (N = 512, M = 8192, D = 32) that is 134 M exps against
// 16 MB written, so the kernel is bound by compute, not by memory.
//
// Design, simple and exact first: one thread per output element, in 2-D
// blocks with threadIdx.x along M, so the row of `out` and the u2/c2 reads
// are coalesced and u1/c1 are warp-wide broadcasts. The D loop uses expf
// (not __expf), the P power sums and the Newton-Girard recursion live in
// registers (P is a template parameter, 1..8), the E extra grams are a
// second loop, and the store is masked so ragged N and M need no padding.
// Left for later: staging u/c tiles in shared memory, the approximate exp
// (ex2.approx), and several outputs per thread to amortise the u1/c1 loads.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlockX = 32;  // threads along M
constexpr int kBlockY = 8;   // threads along N

template <int P>
__device__ __forceinline__ void accumulate(float (&s)[P], float g) {
  float gp = g;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s[p] += gp;
    gp *= g;
  }
}

template <int P>
__global__ void __launch_bounds__(kBlockX * kBlockY)
oak_gram_fwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                    const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ extra,
                    const float* __restrict__ logb,
                    const float* __restrict__ sig2, float* __restrict__ out,
                    int D, int N, int M, int E, int blocks_m) {
  // a 1-D grid of 2-D tiles, so N is not bound by gridDim.y's 65535
  const int tile_i = blockIdx.x / blocks_m;
  const int tile_j = blockIdx.x - tile_i * blocks_m;
  const int i = tile_i * kBlockY + threadIdx.y;
  const int j = tile_j * kBlockX + threadIdx.x;
  if (i >= N || j >= M) return;

  float s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = 0.0f;

  for (int d = 0; d < D; ++d) {
    const float du = u1[(size_t)d * N + i] - u2[(size_t)d * M + j];
    const float g = expf(logb[d] - du * du) -
                    c1[(size_t)d * N + i] * c2[(size_t)d * M + j];
    accumulate<P>(s, g);
  }
  const size_t nm = (size_t)N * M;
  const size_t ij = (size_t)i * M + j;
  for (int e = 0; e < E; ++e) accumulate<P>(s, extra[(size_t)e * nm + ij]);

  float en[P + 1];
  en[0] = 1.0f;
  float acc = sig2[0];
#pragma unroll
  for (int n = 1; n <= P; ++n) {
    float t = 0.0f;
#pragma unroll
    for (int k = 1; k <= n; ++k) {
      const float term = en[n - k] * s[k - 1];  // en[0] = 1
      t += (k % 2 == 1) ? term : -term;
    }
    en[n] = t / (float)n;
    acc += sig2[n] * en[n];
  }
  out[ij] = acc;
}

template <int P>
void launch(const float* u1, const float* u2, const float* c1, const float* c2,
            const float* extra, const float* logb, const float* sig2,
            float* out, int D, int N, int M, int E, cudaStream_t stream) {
  const int blocks_m = (M + kBlockX - 1) / kBlockX;
  const int blocks_n = (N + kBlockY - 1) / kBlockY;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((unsigned)blocks_m * (unsigned)blocks_n);
  oak_gram_fwd_kernel<P><<<grid, block, 0, stream>>>(
      u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, blocks_m);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Depth P in 1..8.
extern "C" int oak_gram_fwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, float* out, int D, int N,
                                int M, int E, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: launch<1>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 2: launch<2>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 3: launch<3>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 4: launch<4>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 5: launch<5>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 6: launch<6>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 7: launch<7>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    case 8: launch<8>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
