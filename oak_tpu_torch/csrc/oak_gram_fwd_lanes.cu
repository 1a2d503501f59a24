// The lane-batched instantiation of the forward kernel (oak_gram_fwd.cu,
// oak_gram_fwd.cuh), in a file of its own so that nvcc compiles it beside
// the one-lane kernels.

#include "oak_gram_fwd.cuh"

namespace oak {

cudaError_t gram_fwd_lanes(const float* u1, const float* u2, const float* c1,
                           const float* c2, const float* extra, const float* logb,
                           const float* sig2, float* out, int D, int N, int M, int E, int P,
                           int variant, int L, const LaneStrides& lanes, cudaStream_t s) {
  return gram_fwd<true>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E, P, variant, L,
                        lanes, s);
}

}  // namespace oak
