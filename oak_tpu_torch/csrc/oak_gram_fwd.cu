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
// logb [D]; sig2 [P + 1]; out [N, M]. P is the clamped depth, 1..64. With L
// lanes (oak_gram_common.cuh, LaneStrides) each input holds L such slices
// at its lane stride, or one that all lanes share, and out is [L, N, M]:
// the blocks of lane l (blockIdx.y) run the one-lane kernel on its slices,
// so each lane's bits are those of a one-lane launch of the same tile.
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

#include "oak_gram_fwd.cuh"

using namespace oak;

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
// oak_gram_fwd_tile. L lanes, 1..65535, with lane_strides[7] the lane
// strides of u1, u2, c1, c2, extra, logb, sig2 (L = 1 with zero strides is
// the one-lane call); out is [L, N, M].
extern "C" int oak_gram_fwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, float* out, int D, int N,
                                int M, int E, int P, int variant, int L,
                                const long long* lane_strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LaneStrides lanes;
  if (P < 1 || P > kMaxDepth || variant < 0 || variant > 1 || L < 1 || L > 65535 ||
      !read_lanes(&lanes, lane_strides, 7))
    return (int)cudaErrorInvalidValue;
  return (int)(L == 1 ? gram_fwd<false>(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E,
                                        P, variant, 1, lanes, s)
                      : gram_fwd_lanes(u1, u2, c1, c2, extra, logb, sig2, out, D, N, M, E,
                                       P, variant, L, lanes, s));
}
