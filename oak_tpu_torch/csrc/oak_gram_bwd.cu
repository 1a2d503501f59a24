// Fused OAK gram backward for Hopper (sm_90a).
//
// Replaces the TPU kernel oak_tpu/ops/oak_gram_pallas.py::_gram_bwd_kernel
// (launched by _pallas_gram_bwd), and covers the extra (binary, categorical)
// grams too, as oak_tpu's _res_bwd does and the TPU kernel did not. For a
// cotangent gbar [N, M] of out = oak_gram_fwd_f32(...) it recomputes, per
// output element (i, j),
//
//   bE_d = exp(logb[d] - (u1[d,i] - u2[d,j])^2),  g_d = bE_d - c1[d,i] c2[d,j]
//   e_0..e_P                                       (power sums, Newton-Girard)
//
// and then, per dim, the downdate h_0 = 1, h_k = e_k - g_d h_{k-1} (so that
// h_k is e_k of the other dims) and
//
//   W_d = sum_{n=1..P} sig2[n] h_{n-1},   T_d = gbar W_d   (= gbar dout/dg_d)
//
//   du1[d,i]  = -2 sum_j T bE du      du2[d,j]  = +2 sum_i T bE du
//   dc1[d,i]  =   -sum_j T c2         dc2[d,j]  =   -sum_i T c1
//   dlogb[d]  =    sum_ij T bE        dsig2[n]  =    sum_ij gbar e_n
//   dextra[e,i,j] = gbar W_{D+e}
//
// with du = u1[d,i] - u2[d,j]. Layouts, all float32 and contiguous: u1, c1
// [D, N]; u2, c2 [D, M]; extra, dextra [E, N, M]; logb [D]; sig2 [P + 1];
// gbar [N, M].
//
// The reductions are deterministic, with no atomics: each block writes
// per-tile partials, which the wrapper (ops/oak_gram.py) sums with torch:
//   du1p, dc1p [blocks_m, D, N]   (one row per column tile)
//   du2p, dc2p [blocks_n, D, M]   (one row per row tile)
//   dlogbp [blocks, D], dsig2p [blocks, P + 1]
// Along M a warp shuffle sums the 32 lanes; along N shared memory sums the 8
// warps of a block.
//
// What bounds it on this card: per (element, dim) two exps (one in each
// pass: the D grams of a tile do not fit on chip, where the TPU kernel kept
// them all in VMEM) and about 4P + 20 FP32 operations, plus five warp sums
// per (row, dim). At the training shape (Kuf: N = 512, M = 8192, D = 32)
// that is 268 M exps against about 16 MB of gbar read and 48 MB of partials
// written: bound by compute, not by memory.
//
// Design, simple and exact first: a block of 32 x 8 threads covers a tile of
// 32 rows x 64 columns, each thread 4 rows (ty + 8r) x 2 columns (tx + 32c),
// so the gbar reads are coalesced and the u1/c1 reads are warp broadcasts.
// Pass 1 keeps e_0..e_P of the thread's 8 elements in registers (P is a
// template parameter, 1..8). Pass 2 runs over the dims with the dim loop
// outermost, so that each dim's sums are scalars in registers and are
// reduced and written before the next dim. Ragged N and M are handled by
// clamped loads and a zero cotangent outside the output, so every thread
// takes part in the shuffles and barriers.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;          // threads along M (threadIdx.x)
constexpr int kWarps = 8;           // threads along N (threadIdx.y)
constexpr int kRows = 4;            // rows per thread
constexpr int kCols = 2;            // columns per thread
constexpr int kTileN = 32;          // rows per block
constexpr int kTileM = 64;          // columns per block
constexpr int kElems = kRows * kCols;
static_assert(kTileN == kWarps * kRows, "tile rows");
static_assert(kTileM == kLanes * kCols, "tile columns");
static_assert(2 * kTileM < kLanes * kWarps, "one thread per column sum, and one spare");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <int P>
__device__ __forceinline__ void accumulate(float (&s)[P], float g) {
  float gp = g;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s[p] += gp;
    gp *= g;
  }
}

// W = sum_{n=1..P} sig2[n] h_{n-1}, by the downdate h_k = e_k - g h_{k-1}.
template <int P>
__device__ __forceinline__ float downdate_weight(const float (&en)[P + 1],
                                                 const float (&sg)[P + 1],
                                                 float g) {
  float h = 1.0f;
  float w = sg[1];
#pragma unroll
  for (int k = 1; k < P; ++k) {
    h = en[k] - g * h;
    w += sg[k + 1] * h;
  }
  return w;
}

template <int P>
__global__ void __launch_bounds__(kLanes * kWarps)
oak_gram_bwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                    const float* __restrict__ c1, const float* __restrict__ c2,
                    const float* __restrict__ extra,
                    const float* __restrict__ logb,
                    const float* __restrict__ sig2,
                    const float* __restrict__ gbar, float* __restrict__ du1p,
                    float* __restrict__ dc1p, float* __restrict__ du2p,
                    float* __restrict__ dc2p, float* __restrict__ dlogbp,
                    float* __restrict__ dsig2p, float* __restrict__ dextra,
                    int D, int N, int M, int E, int blocks_m) {
  __shared__ float s_du2[kWarps][kTileM];
  __shared__ float s_dc2[kWarps][kTileM];
  __shared__ float s_red[kWarps][P + 1];

  const int tile_i = blockIdx.x / blocks_m;
  const int tile_j = blockIdx.x - tile_i * blocks_m;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + tx;
  const size_t nm = (size_t)N * M;

  int row[kRows], col[kCols];  // clamped into range for the loads
  bool row_ok[kRows], col_ok[kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = tile_i * kTileN + ty + kWarps * r;
    row_ok[r] = i < N;
    row[r] = row_ok[r] ? i : N - 1;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = tile_j * kTileM + tx + kLanes * c;
    col_ok[c] = j < M;
    col[c] = col_ok[c] ? j : M - 1;
  }

  float sg[P + 1];
#pragma unroll
  for (int n = 0; n <= P; ++n) sg[n] = sig2[n];

  // pass 1: e_0..e_P and the cotangent of each element; dsig2's sums
  float en[kElems][P + 1];
  float gb[kElems];
  float ds[P + 1];
#pragma unroll
  for (int n = 0; n <= P; ++n) ds[n] = 0.0f;
#pragma unroll
  for (int el = 0; el < kElems; ++el) {
    const int r = el / kCols, c = el % kCols;
    const size_t ij = (size_t)row[r] * M + col[c];
    gb[el] = (row_ok[r] && col_ok[c]) ? gbar[ij] : 0.0f;
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float du = u1[(size_t)d * N + row[r]] - u2[(size_t)d * M + col[c]];
      const float g = expf(logb[d] - du * du) -
                      c1[(size_t)d * N + row[r]] * c2[(size_t)d * M + col[c]];
      accumulate<P>(s, g);
    }
    for (int e = 0; e < E; ++e) accumulate<P>(s, extra[(size_t)e * nm + ij]);
    en[el][0] = 1.0f;
#pragma unroll
    for (int n = 1; n <= P; ++n) {
      float t = 0.0f;
#pragma unroll
      for (int k = 1; k <= n; ++k) {
        const float term = en[el][n - k] * s[k - 1];
        t += (k % 2 == 1) ? term : -term;
      }
      en[el][n] = t / (float)n;
    }
#pragma unroll
    for (int n = 0; n <= P; ++n) ds[n] += gb[el] * en[el][n];
  }
#pragma unroll
  for (int n = 0; n <= P; ++n) {
    const float v = warp_sum(ds[n]);
    if (tx == 0) s_red[ty][n] = v;
  }
  __syncthreads();
  if (tid <= P) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_red[w][tid];
    dsig2p[(size_t)blockIdx.x * (P + 1) + tid] = v;
  }
  __syncthreads();

  // pass 2, one dim at a time: recompute g_d, downdate, reduce, write
  for (int d = 0; d < D; ++d) {
    const float lb = logb[d];
    float u2v[kCols], c2v[kCols], col_du[kCols], col_dc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      u2v[c] = u2[(size_t)d * M + col[c]];
      c2v[c] = c2[(size_t)d * M + col[c]];
      col_du[c] = 0.0f;
      col_dc[c] = 0.0f;
    }
    float row_du[kRows], row_dc[kRows];
    float db = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float u1v = u1[(size_t)d * N + row[r]];
      const float c1v = c1[(size_t)d * N + row[r]];
      row_du[r] = 0.0f;
      row_dc[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int el = r * kCols + c;
        const float du = u1v - u2v[c];
        const float bE = expf(lb - du * du);
        const float g = bE - c1v * c2v[c];
        const float T = gb[el] * downdate_weight<P>(en[el], sg, g);
        const float TbEdu = T * bE * du;
        row_du[r] -= 2.0f * TbEdu;
        row_dc[r] -= T * c2v[c];
        col_du[c] += 2.0f * TbEdu;
        col_dc[c] -= T * c1v;
        db += T * bE;
      }
    }
    // along M: the warp's 32 lanes share its rows
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float vu = warp_sum(row_du[r]);
      const float vc = warp_sum(row_dc[r]);
      if (tx == 0 && row_ok[r]) {
        const size_t at = ((size_t)tile_j * D + d) * N + row[r];
        du1p[at] = vu;
        dc1p[at] = vc;
      }
    }
    db = warp_sum(db);
    // along N: the block's 8 warps share its columns
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      s_du2[ty][tx + kLanes * c] = col_du[c];
      s_dc2[ty][tx + kLanes * c] = col_dc[c];
    }
    if (tx == 0) s_red[ty][0] = db;
    __syncthreads();
    if (tid < 2 * kTileM) {
      const int cc = tid % kTileM;
      const float(*src)[kTileM] = tid < kTileM ? s_du2 : s_dc2;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += src[w][cc];
      const int j = tile_j * kTileM + cc;
      if (j < M) (tid < kTileM ? du2p : dc2p)[((size_t)tile_i * D + d) * M + j] = v;
    } else if (tid == 2 * kTileM) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_red[w][0];
      dlogbp[(size_t)blockIdx.x * D + d] = v;
    }
    __syncthreads();
  }

  // the extra grams: no reduction, one cotangent per element
  if (dextra != nullptr) {
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int el = 0; el < kElems; ++el) {
        const int r = el / kCols, c = el % kCols;
        if (!(row_ok[r] && col_ok[c])) continue;
        const size_t at = (size_t)e * nm + (size_t)row[r] * M + col[c];
        dextra[at] = gb[el] * downdate_weight<P>(en[el], sg, extra[at]);
      }
    }
  }
}

template <int P>
void launch(const float* u1, const float* u2, const float* c1, const float* c2,
            const float* extra, const float* logb, const float* sig2,
            const float* gbar, float* du1p, float* dc1p, float* du2p,
            float* dc2p, float* dlogbp, float* dsig2p, float* dextra, int D,
            int N, int M, int E, cudaStream_t stream) {
  const int blocks_m = (M + kTileM - 1) / kTileM;
  const int blocks_n = (N + kTileN - 1) / kTileN;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((unsigned)blocks_m * (unsigned)blocks_n);
  oak_gram_bwd_kernel<P><<<grid, block, 0, stream>>>(
      u1, u2, c1, c2, extra, logb, sig2, gbar, du1p, dc1p, du2p, dc2p, dlogbp,
      dsig2p, dextra, D, N, M, E, blocks_m);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Depth P in 1..8.
// dextra may be null: the extra grams' cotangent is then not written.
extern "C" int oak_gram_bwd_f32(const float* u1, const float* u2,
                                const float* c1, const float* c2,
                                const float* extra, const float* logb,
                                const float* sig2, const float* gbar,
                                float* du1p, float* dc1p, float* du2p,
                                float* dc2p, float* dlogbp, float* dsig2p,
                                float* dextra, int D, int N, int M, int E,
                                int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OAK_BWD_CASE(p)                                                     \
  case p:                                                                   \
    launch<p>(u1, u2, c1, c2, extra, logb, sig2, gbar, du1p, dc1p, du2p,    \
              dc2p, dlogbp, dsig2p, dextra, D, N, M, E, s);                 \
    break;
  switch (P) {
    OAK_BWD_CASE(1)
    OAK_BWD_CASE(2)
    OAK_BWD_CASE(3)
    OAK_BWD_CASE(4)
    OAK_BWD_CASE(5)
    OAK_BWD_CASE(6)
    OAK_BWD_CASE(7)
    OAK_BWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OAK_BWD_CASE
  return (int)cudaGetLastError();
}
