// The lane-batched instantiation of the backward kernels (oak_gram_bwd.cu,
// oak_gram_bwd.cuh), in a file of its own so that nvcc compiles it beside
// the one-lane kernels.

#include "oak_gram_bwd.cuh"

namespace oak {

cudaError_t gram_bwd_lanes(const float* u1, const float* u2, const float* c1,
                           const float* c2, const float* extra, const float* logb,
                           const float* sig2, const float* gbar, float* work, float* du1,
                           float* dc1, float* du2, float* dc2, float* dlogb, float* dsig2,
                           float* dextra, int D, int N, int M, int E, int P, int variant,
                           int L, const LaneStrides& lanes, cudaStream_t s) {
  return gram_bwd<true>(u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1, dc1, du2, dc2,
                        dlogb, dsig2, dextra, D, N, M, E, P, variant, L, lanes, s);
}

}  // namespace oak
