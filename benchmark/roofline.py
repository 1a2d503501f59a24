"""Frozen counts of the work the port's kernels and steps do, from the
shapes alone, and the peaks of one NVIDIA H100 SXM from its data sheet.

The counts are of what the mathematics of these inputs needs, not of what
one implementation emits, so that a kernel that does the same work in
fewer instructions still reads at most 100 % of its roofline. Each input
byte is counted as read once and each output byte as written once.

The OAK gram of inputs prescaled as u = x / (l sqrt 2), c = cov(x) / sqrt(var_s)
(a kernel may fold more constants in, never fewer operations out) needs, per
(element, RBF dim), at the depth P clamped to the number of grams:

- the forward (K1): one exponential, and 3 + P FP32 operations (the
  difference, the exponent as one FMA, g = e - c c' as one FMA, and one FMA
  per order of the product expansion); per element P more for the sum over
  the orders weighted by sigma2;
- the backward (K2): the forward again (its e_n are needed before any
  dim's derivative), P FMAs for d K / d g_d by Horner's rule on the
  per-element coefficients T_j = sum_{n > j} sigma2_n e_{n-1-j}, and 6 for
  the chain into u, u', c, c' and log b (the factor gbar folded into T);
  per element P (P + 1) / 2 for T, P for gbar times T, and P + 1 for the
  sums that give d sigma2. One exponential a pair suffices.

An FMA is one FP32 operation against the lane rate, and two FLOPs against
the data sheet's 67 TFLOP/s; an exponential is one operation of the
special-function units.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit: 67 TFLOP/s
# FP32 outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz),
# 3.35 TB/s of HBM3; the special-function units give 16 exponentials per SM
# a clock (the CUDA C++ programming manual's arithmetic instruction throughput
# of compute capability 9.0), 132 x 16 x 1.98 GHz.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2  # FMA lanes a second
PEAK_EX2 = 132 * 16 * 1.98e9
PEAK_HBM_BYTES = 3.35e12
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float  # FP32 lane operations, an FMA counted once
    ex2: float  # exponentials
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.ex2 + other.ex2, self.bytes + other.bytes)

    def bound_s(self) -> float:
        """The least time the card could take: the slowest of its three
        limits."""
        return max(self.ops / PEAK_FP32_OPS, self.ex2 / PEAK_EX2,
                   self.bytes / PEAK_HBM_BYTES)

    def limiter(self) -> str:
        t = {"FP32": self.ops / PEAK_FP32_OPS, "ex2": self.ex2 / PEAK_EX2,
             "bytes": self.bytes / PEAK_HBM_BYTES}
        return max(t, key=t.get)


def clamped_depth(depth: int, D: int, E: int = 0) -> int:
    """e_n of D + E grams is 0 for n > D + E."""
    return min(depth, D + E)


def k1(N: int, M: int, D: int, depth: int, E: int = 0, lanes: int = 1) -> Work:
    """The forward gram [N, M] of D RBF dims and E precomputed extra grams."""
    P, nm = clamped_depth(depth, D, E), N * M
    ops = nm * (D * (3 + P) + E * P + P)
    ex2 = nm * D
    nbytes = F32 * (2 * D * (N + M) + D + (P + 1) + E * nm + nm)
    return Work(lanes * ops, lanes * ex2, lanes * nbytes)


def k2(N: int, M: int, D: int, depth: int, E: int = 0, lanes: int = 1) -> Work:
    """The backward of ``k1``: gbar [N, M] in; d u, d c of both sides,
    d log b [D] and d sigma2 [P + 1] out (d extra [E, N, M] when E > 0)."""
    P, nm = clamped_depth(depth, D, E), N * M
    ops = nm * (D * ((3 + P) + P + 6) + E * (2 * P - 1)
                + P * (P + 1) // 2 + P + (P + 1))
    ex2 = nm * D
    nbytes = F32 * (4 * D * (N + M) + 2 * D + 2 * (P + 1) + 2 * E * nm + nm)
    return Work(lanes * ops, lanes * ex2, lanes * nbytes)


# --------------------------------------------------------------------------- #
# Model FLOPs of a whole evaluation (an FMA is 2 FLOPs, an exponential 1)
# --------------------------------------------------------------------------- #
def gram_flops(N: int, M: int, D: int, depth: int, backward: bool) -> float:
    P, nm = clamped_depth(depth, D), N * M
    fwd = nm * (D * (2 * (2 + P) + 1 + 1) + 2 * P)  # sub, 2 + P FMAs, exp
    if not backward:
        return fwd
    # forward again, P FMAs of Horner, the chain (2 products, 4 FMAs) and
    # the per-element coefficients
    bwd = fwd + nm * (D * (2 * P + 2 + 8) + P * (P + 1) + 2 * P + 2 * (P + 1))
    return fwd + bwd


def diag_flops(N: int, D: int, depth: int) -> float:
    P = clamped_depth(depth, D)
    return N * (D * (8 + 2 * P) + 2 * P)


def svgp_step_flops(N: int, M: int, D: int, depth: int) -> float:
    """One loss-and-gradient evaluation of the whitened SVGP with a diagonal
    q(u) and a Gaussian likelihood over N rows: the grams Kuu and Kuf
    forward and backward, K_diag, chol(Kuu), A = Luu^-1 Kuf, the predictive
    mean and variance, and the backward of the linear algebra."""
    grams = gram_flops(M, M, D, depth, True) + gram_flops(M, N, D, depth, True)
    fwd = M ** 3 / 3 + M * M * N + 3 * 2 * M * N
    # d A from the mean and the variance (3 products), the triangular
    # solve's backward (a solve and a product), the Cholesky's backward
    bwd = 3 * 2 * M * N + M * M * N + 2 * M * M * N + M ** 3
    return grams + 2 * diag_flops(N, D, depth) + fwd + bwd


def sgpr_flops(N: int, M: int, D: int, depth: int, backward: bool) -> float:
    """One evaluation of the SGPR collapsed bound over N rows, without or
    with its gradient: Kuu and Kuf, K_diag, chol(Kuu), A = L^-1 Kuf / sigma,
    A A^T (symmetric, M^2 N), chol(I + A A^T), A y and the solve for c."""
    grams = gram_flops(M, M, D, depth, backward) + gram_flops(M, N, D, depth, backward)
    fwd = 2 * M ** 3 / 3 + 2 * M * M * N + 4 * M * N + M * M
    if not backward:
        return grams + diag_flops(N, D, depth) + fwd
    # d A = 2 d(AA^T) A, the solve's backward (a solve and a product), two
    # Cholesky backwards
    bwd = 2 * M * M * N + M * M * N + 2 * M * M * N + 2 * M ** 3 + 4 * M * N
    return grams + 2 * diag_flops(N, D, depth) + fwd + bwd


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * PEAK_FP32_FLOPS)
