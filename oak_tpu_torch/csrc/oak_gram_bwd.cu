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
// With L lanes (oak_gram_common.cuh, LaneStrides) the inputs hold L slices
// at their lane strides, or one that all lanes share; the outputs are dense
// [L, ...] and the workspace holds one lane's partials after another. Lane l
// runs on the blocks whose blockIdx.y is l, in both kernels, as a one-lane
// launch of the same tile would: the same bits, lane by lane.
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

#include "oak_gram_bwd.cuh"

using namespace oak;

// The block tile (rows bn x columns bm) the backward kernel takes at clamped
// depth P for variant 0 (large) or 1 (small). Returns a cudaError_t.
extern "C" int oak_gram_bwd_tile(int P, int variant, int* bn, int* bm) {
  if (!valid(P, variant)) return (int)cudaErrorInvalidValue;
  const int pmax = depth_bucket(P);
  *bn = kThreadsY * bwd_rows(pmax, variant);
  *bm = kThreadsX * bwd_cols(pmax, variant);
  return 0;
}

// Floats of workspace oak_gram_bwd_f32 needs for these sizes and L lanes
// (the per-tile partials); -1 for an invalid depth, variant or L.
extern "C" long long oak_gram_bwd_workspace(int D, int N, int M, int P,
                                            int variant, int L) {
  if (!valid(P, variant) || L < 1 || L > 65535) return -1;
#define OAK_WS(pmax, v) L * workspace_floats<pmax, v>(D, N, M, P)
  OAK_BWD_DISPATCH(OAK_WS)
#undef OAK_WS
}

// Returns the cudaError_t of the launches (0 on success): the tile kernel,
// then oak_gram_bwd_reduce. P is the clamped depth, 1..64; dsig2 gets P + 1
// entries a lane. work holds oak_gram_bwd_workspace(D, N, M, P, variant, L)
// floats. dextra may be null: the extra grams' cotangent is then not
// written. L lanes, 1..65535, with lane_strides[8] the lane strides of u1,
// u2, c1, c2, extra, logb, sig2, gbar (L = 1 with zero strides is the
// one-lane call); every output is [L, ...].
extern "C" int oak_gram_bwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, const float* gbar,
                                float* work, float* du1, float* dc1,
                                float* du2, float* dc2, float* dlogb,
                                float* dsig2, float* dextra, int D, int N,
                                int M, int E, int P, int variant, int L,
                                const long long* lane_strides, void* stream) {
  LaneStrides lanes;
  if (!valid(P, variant) || L < 1 || L > 65535 || !read_lanes(&lanes, lane_strides, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(L == 1 ? gram_bwd<false>(u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1,
                                        dc1, du2, dc2, dlogb, dsig2, dextra, D, N, M, E, P,
                                        variant, 1, lanes, s)
                      : gram_bwd_lanes(u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1,
                                       dc1, du2, dc2, dlogb, dsig2, dextra, D, N, M, E, P,
                                       variant, L, lanes, s));
}
#undef OAK_BWD_DISPATCH
