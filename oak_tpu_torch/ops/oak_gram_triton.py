"""K1, the fused OAK gram forward, as a Triton kernel: the gram of the
card's compiled predict artifact (``serving.serialize_predict``).

Replaces the TPU kernel oak_tpu/ops/oak_gram_pallas.py::_gram_kernel
(launched by ``_pallas_gram``) inside the AOTInductor package of a served
model. On ``ops.oak_gram._prep``'s inputs it computes what
``oak_gram.oak_gram_plain`` and the CUDA kernel csrc/oak_gram_fwd.cu compute:

    g_d    = exp(logb_d - (u1_d,i - u2_d,j)²) - c1_d,i c2_d,j    d < D
    g_D+k  = extra_k,i,j                                          k < E
    out    = σ²_0 + Σ_{n=1..P} σ²_n e_n(g),

e_n by the product expansion e_n += g e_{n-1} (n = P..1, one FMA per order;
never float32 Newton–Girard, which drifts at depth), at the clamped depth
P = min(depth, D + E) <= 64 (``oak_gram.clamped_depth``).

Why Triton beside the CUDA kernel: AOTInductor compiles a Triton kernel
reached through ``torch.library.triton_op`` into the package's cubins, so
the package holds its gram and loads with torch alone; the CUDA kernel,
bound with ctypes, would stay an opaque call into this package. The CUDA
kernel remains the gram of every live path.

What bounds it on this card: as csrc/oak_gram_fwd.cu, per (element, dim)
one ex2 and 3 + P FP32 operations while only O((N + M) D + (E + 1) N M)
bytes move, so the ex2 units bound it at depth <= 4 and the FP32 lanes
deeper (``chip_smoke.gram_bound``). With no shared memory of its own, a
program also issues each thread's loads and prescales of its rows' and
columns' u and c every dim, which the tiles keep to about one instruction
an output.

Design: one program per [BN, BM] tile of the output, on a 1-D grid over
the tiles (the served batch, on either axis, meets no grid limit). A loop
over the D dims forms each dim's gram from the tile's rows' and columns'
u, c (exp2 on u prescaled by sqrt(log2 e) and logb by log2 e, as the CUDA
kernel stages them) and folds it into e_1..e_P; then a loop over the E
extra grams loads them as [BN, BM] blocks; no branch in either. The orders
start as a load of the output tile with no lane enabled, which gives the
whole program the layout of its 2-D loads and store: a thread holds BN rows
and runs of up to 4 columns, so the columns' u and c load straight into
it (from tl.zeros the program took Triton's default layout, one column a
thread, and a vectorised column load crossed shared memory every dim).
Loads of the dims carry masks but no ``other``, so no lane's register is
zeroed first; masked lanes' values only reach outputs that are never
stored. Logb and σ² are scalars fed to the FMAs. Unrolling the dim loop
by 2 lets the next dim's loads issue during this one's exps where a tile
gains by it (a pipeline of cp.async stages, ``tl.range(num_stages=)``, was
slower at most shapes measured). Triton has no per-thread arrays, so the
orders are P block tensors named e1..e64 in the source, each updated only
under a ``P >= n`` test on the constexpr P in one jitted helper that both
loops call (``fold_orders``): the compiler drops the orders above P. One
kernel is compiled per clamped depth; its tile (``_config``) comes from
the depth alone, so an exported program, whose batch is symbolic, takes
it without a guard. Every FMA is explicit, in the CUDA kernel's order;
the negated FMAs (the exponent, g), the prescale multiply and exp2 are the
CUDA kernel's PTX instructions, written inline (Triton's unary minus is a
subtraction from 0, an FADD of its own), so the two kernels give the same
bits (``chip_smoke.py`` phases 2 and 10.4 count the cases).

On CUDA tensors the op launches the kernel or raises (``oak_gram.
_check_cuda_inputs``' conditions); on CPU tensors it is the plain version.
``triton`` is imported at the first launch, not with this module.
"""

from __future__ import annotations

import functools
import logging
from typing import Sequence, Tuple

import torch

from ..utils import profiling
from . import oak_gram as og

# Launches of the Triton kernel by the eager op in this process, also
# ``k1_triton.launches`` in ``utils.profiling``'s counters while a session
# records. The compiled package launches its copy from C++, which no counter
# here sees: torch.profiler's kernel names count those.
LAUNCHES = 0

# Its name, as it shows in torch.profiler's kernel names.
KERNEL_NAME = "oak_gram_fwd_triton_kernel"

tl = None  # triton.language, bound by _kernel() at the first launch


# Registers of orders e_1..e_P a thread may hold (P times its outputs): the
# budget of every tile below, which leaves the rest of a thread's 255 to its
# other state.
ORDER_REGISTERS = 128

# (BN, BM, num_warps, unroll of the dim loop) of each depth bucket: one tile
# a bucket, the fastest at the bench's and pumadyn's Kus in a sweep on an
# H100 (PERF.md §6). A thread holds BN BM / (32 warps) outputs.
_TILES = {4: (4, 512, 4, 1),
          8: (4, 128, 4, 2),
          16: (8, 32, 4, 1),
          32: (8, 32, 4, 2),
          64: (2, 128, 4, 2)}


def _config(P: int) -> Tuple[int, int, int, int]:
    """(BN, BM, num_warps, unroll) at clamped depth P: its bucket's tile.
    Never from the batch, which an exported program holds symbolic."""
    return _TILES[next(bucket for bucket in _TILES if P <= bucket)]


def fold_orders(g, e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16,
                e17, e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30,
                e31, e32, e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44,
                e45, e46, e47, e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58,
                e59, e60, e61, e62, e63, e64, P: tl.constexpr):
    """e_n += g e_{n-1} for n = P..1 on the orders e1..e64 (those above P
    pass through): highest order first, so each reads the old e_{n-1}, every
    FMA explicit and in the CUDA kernel's order, so both give one result.
    The one copy of the fold, for the dims and the extra grams alike; the
    kernel inlines it."""
    if P >= 64: e64 = tl.fma(g, e63, e64)
    if P >= 63: e63 = tl.fma(g, e62, e63)
    if P >= 62: e62 = tl.fma(g, e61, e62)
    if P >= 61: e61 = tl.fma(g, e60, e61)
    if P >= 60: e60 = tl.fma(g, e59, e60)
    if P >= 59: e59 = tl.fma(g, e58, e59)
    if P >= 58: e58 = tl.fma(g, e57, e58)
    if P >= 57: e57 = tl.fma(g, e56, e57)
    if P >= 56: e56 = tl.fma(g, e55, e56)
    if P >= 55: e55 = tl.fma(g, e54, e55)
    if P >= 54: e54 = tl.fma(g, e53, e54)
    if P >= 53: e53 = tl.fma(g, e52, e53)
    if P >= 52: e52 = tl.fma(g, e51, e52)
    if P >= 51: e51 = tl.fma(g, e50, e51)
    if P >= 50: e50 = tl.fma(g, e49, e50)
    if P >= 49: e49 = tl.fma(g, e48, e49)
    if P >= 48: e48 = tl.fma(g, e47, e48)
    if P >= 47: e47 = tl.fma(g, e46, e47)
    if P >= 46: e46 = tl.fma(g, e45, e46)
    if P >= 45: e45 = tl.fma(g, e44, e45)
    if P >= 44: e44 = tl.fma(g, e43, e44)
    if P >= 43: e43 = tl.fma(g, e42, e43)
    if P >= 42: e42 = tl.fma(g, e41, e42)
    if P >= 41: e41 = tl.fma(g, e40, e41)
    if P >= 40: e40 = tl.fma(g, e39, e40)
    if P >= 39: e39 = tl.fma(g, e38, e39)
    if P >= 38: e38 = tl.fma(g, e37, e38)
    if P >= 37: e37 = tl.fma(g, e36, e37)
    if P >= 36: e36 = tl.fma(g, e35, e36)
    if P >= 35: e35 = tl.fma(g, e34, e35)
    if P >= 34: e34 = tl.fma(g, e33, e34)
    if P >= 33: e33 = tl.fma(g, e32, e33)
    if P >= 32: e32 = tl.fma(g, e31, e32)
    if P >= 31: e31 = tl.fma(g, e30, e31)
    if P >= 30: e30 = tl.fma(g, e29, e30)
    if P >= 29: e29 = tl.fma(g, e28, e29)
    if P >= 28: e28 = tl.fma(g, e27, e28)
    if P >= 27: e27 = tl.fma(g, e26, e27)
    if P >= 26: e26 = tl.fma(g, e25, e26)
    if P >= 25: e25 = tl.fma(g, e24, e25)
    if P >= 24: e24 = tl.fma(g, e23, e24)
    if P >= 23: e23 = tl.fma(g, e22, e23)
    if P >= 22: e22 = tl.fma(g, e21, e22)
    if P >= 21: e21 = tl.fma(g, e20, e21)
    if P >= 20: e20 = tl.fma(g, e19, e20)
    if P >= 19: e19 = tl.fma(g, e18, e19)
    if P >= 18: e18 = tl.fma(g, e17, e18)
    if P >= 17: e17 = tl.fma(g, e16, e17)
    if P >= 16: e16 = tl.fma(g, e15, e16)
    if P >= 15: e15 = tl.fma(g, e14, e15)
    if P >= 14: e14 = tl.fma(g, e13, e14)
    if P >= 13: e13 = tl.fma(g, e12, e13)
    if P >= 12: e12 = tl.fma(g, e11, e12)
    if P >= 11: e11 = tl.fma(g, e10, e11)
    if P >= 10: e10 = tl.fma(g, e9, e10)
    if P >= 9: e9 = tl.fma(g, e8, e9)
    if P >= 8: e8 = tl.fma(g, e7, e8)
    if P >= 7: e7 = tl.fma(g, e6, e7)
    if P >= 6: e6 = tl.fma(g, e5, e6)
    if P >= 5: e5 = tl.fma(g, e4, e5)
    if P >= 4: e4 = tl.fma(g, e3, e4)
    if P >= 3: e3 = tl.fma(g, e2, e3)
    if P >= 2: e2 = tl.fma(g, e1, e2)
    e1 += g
    return (e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16,
            e17, e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30,
            e31, e32, e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44,
            e45, e46, e47, e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58,
            e59, e60, e61, e62, e63, e64)


def oak_gram_fwd_triton_kernel(u1, u2, c1, c2, extra, logb, sig2, out, N, M, D, E,
                               P: tl.constexpr, BN: tl.constexpr, BM: tl.constexpr,
                               UNROLL: tl.constexpr):
    blocks_m = (M + BM - 1) // BM
    t = tl.program_id(0)
    rows = ((t // blocks_m) * BN + tl.arange(0, BN)).to(tl.int64)
    cols = ((t % blocks_m) * BM + tl.arange(0, BM)).to(tl.int64)
    rmask, cmask = rows < N, cols < M
    # zeros, as a load of the output tile with no lane enabled: this puts the
    # orders, and so both loops, in the layout of the tile's 2-D loads and
    # store (from tl.zeros they would take Triton's default layout, and the
    # columns' u and c, loaded vectorised, would cross through shared memory
    # every dim)
    z = tl.load(out + rows[:, None] * M + cols[None, :],
                mask=(rows < 0)[:, None] & cmask[None, :], other=0.0)
    e1, e2, e3, e4, e5, e6, e7, e8 = z, z, z, z, z, z, z, z
    e9, e10, e11, e12, e13, e14, e15, e16 = z, z, z, z, z, z, z, z
    e17, e18, e19, e20, e21, e22, e23, e24 = z, z, z, z, z, z, z, z
    e25, e26, e27, e28, e29, e30, e31, e32 = z, z, z, z, z, z, z, z
    e33, e34, e35, e36, e37, e38, e39, e40 = z, z, z, z, z, z, z, z
    e41, e42, e43, e44, e45, e46, e47, e48 = z, z, z, z, z, z, z, z
    e49, e50, e51, e52, e53, e54, e55, e56 = z, z, z, z, z, z, z, z
    e57, e58, e59, e60, e61, e62, e63, e64 = z, z, z, z, z, z, z, z
    # the dims; unrolled by UNROLL, the next dim's loads issue during this
    # one's exps (the loads carry no `other`: no lane's masked value is read)
    for k in tl.range(0, D, loop_unroll_factor=UNROLL):
        # exp(logb - du²) = exp2(logb log2 e - (du sqrt(log2 e))²); u is
        # prescaled in a multiply rounded on its own (mul.rn, which no FMA
        # absorbs), as the CUDA kernel stages it
        a = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f",
            [tl.load(u1 + k * N + rows, mask=rmask),
             tl.full([BN], 1.2011224087864498, tl.float32)],
            dtype=tl.float32, is_pure=True, pack=1)
        b = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f",
            [tl.load(u2 + k * M + cols, mask=cmask),
             tl.full([BM], 1.2011224087864498, tl.float32)],
            dtype=tl.float32, is_pure=True, pack=1)
        du = a[:, None] - b[None, :]
        # fmaf(-du, du, lb) and ex2.approx.ftz, then fmaf(-c1, c2, ex): the
        # CUDA kernel's instructions, the negations folded into the FMAs
        ex = tl.inline_asm_elementwise(
            "{ .reg .f32 t; neg.f32 t, $1; fma.rn.f32 t, t, $1, $2; ex2.approx.ftz.f32 $0, t; }",
            "=f,f,f", [du, tl.load(logb + k) * 1.4426950408889634],
            dtype=tl.float32, is_pure=True, pack=1)
        g = tl.inline_asm_elementwise(
            "{ .reg .f32 t; neg.f32 t, $1; fma.rn.f32 $0, t, $2, $3; }", "=f,f,f,f",
            [tl.load(c1 + k * N + rows, mask=rmask)[:, None],
             tl.load(c2 + k * M + cols, mask=cmask)[None, :], ex],
            dtype=tl.float32, is_pure=True, pack=1)
        # e_n += g e_{n-1}, every order, in the CUDA kernel's order
        (e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16, e17,
         e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30, e31, e32,
         e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44, e45, e46, e47,
         e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58, e59, e60, e61, e62,
         e63, e64) = fold_orders(
            g, e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16, e17,
            e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30, e31, e32,
            e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44, e45, e46, e47,
            e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58, e59, e60, e61, e62,
            e63, e64, P)

    # the extra grams, [BN, BM] blocks
    mask = rmask[:, None] & cmask[None, :]
    at = rows[:, None] * M + cols[None, :]
    for k in range(0, E):
        g = tl.load(extra + k.to(tl.int64) * N * M + at, mask=mask)
        (e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16, e17,
         e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30, e31, e32,
         e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44, e45, e46, e47,
         e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58, e59, e60, e61, e62,
         e63, e64) = fold_orders(
            g, e1, e2, e3, e4, e5, e6, e7, e8, e9, e10, e11, e12, e13, e14, e15, e16, e17,
            e18, e19, e20, e21, e22, e23, e24, e25, e26, e27, e28, e29, e30, e31, e32,
            e33, e34, e35, e36, e37, e38, e39, e40, e41, e42, e43, e44, e45, e46, e47,
            e48, e49, e50, e51, e52, e53, e54, e55, e56, e57, e58, e59, e60, e61, e62,
            e63, e64, P)

    o = tl.fma(tl.load(sig2 + 1), e1, tl.load(sig2))
    if P >= 2: o = tl.fma(tl.load(sig2 + 2), e2, o)
    if P >= 3: o = tl.fma(tl.load(sig2 + 3), e3, o)
    if P >= 4: o = tl.fma(tl.load(sig2 + 4), e4, o)
    if P >= 5: o = tl.fma(tl.load(sig2 + 5), e5, o)
    if P >= 6: o = tl.fma(tl.load(sig2 + 6), e6, o)
    if P >= 7: o = tl.fma(tl.load(sig2 + 7), e7, o)
    if P >= 8: o = tl.fma(tl.load(sig2 + 8), e8, o)
    if P >= 9: o = tl.fma(tl.load(sig2 + 9), e9, o)
    if P >= 10: o = tl.fma(tl.load(sig2 + 10), e10, o)
    if P >= 11: o = tl.fma(tl.load(sig2 + 11), e11, o)
    if P >= 12: o = tl.fma(tl.load(sig2 + 12), e12, o)
    if P >= 13: o = tl.fma(tl.load(sig2 + 13), e13, o)
    if P >= 14: o = tl.fma(tl.load(sig2 + 14), e14, o)
    if P >= 15: o = tl.fma(tl.load(sig2 + 15), e15, o)
    if P >= 16: o = tl.fma(tl.load(sig2 + 16), e16, o)
    if P >= 17: o = tl.fma(tl.load(sig2 + 17), e17, o)
    if P >= 18: o = tl.fma(tl.load(sig2 + 18), e18, o)
    if P >= 19: o = tl.fma(tl.load(sig2 + 19), e19, o)
    if P >= 20: o = tl.fma(tl.load(sig2 + 20), e20, o)
    if P >= 21: o = tl.fma(tl.load(sig2 + 21), e21, o)
    if P >= 22: o = tl.fma(tl.load(sig2 + 22), e22, o)
    if P >= 23: o = tl.fma(tl.load(sig2 + 23), e23, o)
    if P >= 24: o = tl.fma(tl.load(sig2 + 24), e24, o)
    if P >= 25: o = tl.fma(tl.load(sig2 + 25), e25, o)
    if P >= 26: o = tl.fma(tl.load(sig2 + 26), e26, o)
    if P >= 27: o = tl.fma(tl.load(sig2 + 27), e27, o)
    if P >= 28: o = tl.fma(tl.load(sig2 + 28), e28, o)
    if P >= 29: o = tl.fma(tl.load(sig2 + 29), e29, o)
    if P >= 30: o = tl.fma(tl.load(sig2 + 30), e30, o)
    if P >= 31: o = tl.fma(tl.load(sig2 + 31), e31, o)
    if P >= 32: o = tl.fma(tl.load(sig2 + 32), e32, o)
    if P >= 33: o = tl.fma(tl.load(sig2 + 33), e33, o)
    if P >= 34: o = tl.fma(tl.load(sig2 + 34), e34, o)
    if P >= 35: o = tl.fma(tl.load(sig2 + 35), e35, o)
    if P >= 36: o = tl.fma(tl.load(sig2 + 36), e36, o)
    if P >= 37: o = tl.fma(tl.load(sig2 + 37), e37, o)
    if P >= 38: o = tl.fma(tl.load(sig2 + 38), e38, o)
    if P >= 39: o = tl.fma(tl.load(sig2 + 39), e39, o)
    if P >= 40: o = tl.fma(tl.load(sig2 + 40), e40, o)
    if P >= 41: o = tl.fma(tl.load(sig2 + 41), e41, o)
    if P >= 42: o = tl.fma(tl.load(sig2 + 42), e42, o)
    if P >= 43: o = tl.fma(tl.load(sig2 + 43), e43, o)
    if P >= 44: o = tl.fma(tl.load(sig2 + 44), e44, o)
    if P >= 45: o = tl.fma(tl.load(sig2 + 45), e45, o)
    if P >= 46: o = tl.fma(tl.load(sig2 + 46), e46, o)
    if P >= 47: o = tl.fma(tl.load(sig2 + 47), e47, o)
    if P >= 48: o = tl.fma(tl.load(sig2 + 48), e48, o)
    if P >= 49: o = tl.fma(tl.load(sig2 + 49), e49, o)
    if P >= 50: o = tl.fma(tl.load(sig2 + 50), e50, o)
    if P >= 51: o = tl.fma(tl.load(sig2 + 51), e51, o)
    if P >= 52: o = tl.fma(tl.load(sig2 + 52), e52, o)
    if P >= 53: o = tl.fma(tl.load(sig2 + 53), e53, o)
    if P >= 54: o = tl.fma(tl.load(sig2 + 54), e54, o)
    if P >= 55: o = tl.fma(tl.load(sig2 + 55), e55, o)
    if P >= 56: o = tl.fma(tl.load(sig2 + 56), e56, o)
    if P >= 57: o = tl.fma(tl.load(sig2 + 57), e57, o)
    if P >= 58: o = tl.fma(tl.load(sig2 + 58), e58, o)
    if P >= 59: o = tl.fma(tl.load(sig2 + 59), e59, o)
    if P >= 60: o = tl.fma(tl.load(sig2 + 60), e60, o)
    if P >= 61: o = tl.fma(tl.load(sig2 + 61), e61, o)
    if P >= 62: o = tl.fma(tl.load(sig2 + 62), e62, o)
    if P >= 63: o = tl.fma(tl.load(sig2 + 63), e63, o)
    if P >= 64: o = tl.fma(tl.load(sig2 + 64), e64, o)
    tl.store(out + at, o, mask=mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The jitted kernel, made at the first launch: ``triton`` is imported
    here, never with this module (an installation without a card may have
    none)."""
    global tl, fold_orders
    import triton
    import triton.language as tl

    # the kernel calls the fold by this name (AOTInductor copies it into the
    # package beside the kernel, as a jitted global of the kernel's module)
    fold_orders = triton.jit(fold_orders)
    return triton.jit(oak_gram_fwd_triton_kernel)


def _launch(inputs: Sequence[torch.Tensor], depth: int, traced: bool) -> torch.Tensor:
    """The kernel on the checked CUDA inputs: called directly (eager), or
    through ``torch.library.wrap_triton`` while torch traces the op (its
    sizes may then be symbolic: the batch of an exported program)."""
    og._check_cuda_inputs(inputs, depth)
    u1, u2, c1, c2, extra, logb, sig2 = inputs
    (D, N), M, E = u1.shape, u2.shape[1], extra.shape[0]
    P = og.clamped_depth(depth, D, E)
    # the tile from the depth alone, never the batch M (symbolic when traced:
    # a branch on it would guard or specialise the program)
    BN, BM, warps, unroll = _config(P)
    out = torch.empty((N, M), dtype=torch.float32, device=u1.device)
    kernel = torch.library.wrap_triton(_kernel()) if traced else _kernel()
    # extra is never read when E is 0 (an empty tensor may have no address)
    grid = (((N + BN - 1) // BN) * ((M + BM - 1) // BM),)  # 1-D, over the tiles
    kernel[grid](u1, u2, c1, c2, extra if E else u1, logb, sig2, out, N, M,
                                D, E, P=P, BN=BN, BM=BM, UNROLL=unroll, num_warps=warps)
    return out


def _register():
    # triton_op looks for the kernels in the op's source, and without triton
    # (the CPU) says so at WARNING; it finds none here either way
    log = logging.getLogger("torch._library.triton")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        return torch.library.triton_op("oak_tpu_torch::oak_gram_triton", _traced,
                                       mutates_args=())
    finally:
        log.setLevel(level)


def _traced(u1: torch.Tensor, u2: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
            extra: torch.Tensor, logb: torch.Tensor, sig2: torch.Tensor,
            depth: int) -> torch.Tensor:
    """The op as torch traces it: its fake, and what AOTInductor compiles
    (``wrap_triton`` puts the kernel in the graph). CPU tensors (a program
    traced on the CPU) take the plain version."""
    if not u1.is_cuda:
        return og.oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)
    return _launch((u1, u2, c1, c2, extra, logb, sig2), depth, traced=True)


oak_gram_triton_op = _register()
oak_gram_triton_op.__doc__ = """The gram [N, M] from prescaled inputs as the
registered op ``oak_tpu_torch::oak_gram_triton``: on CUDA tensors the Triton
kernel (checked, then launched; ``LAUNCHES`` counts it), on CPU tensors
``oak_gram.oak_gram_plain``. Same inputs and contract as
``oak_gram.oak_gram_fwd_op``; no autograd (serving takes no gradient)."""


@oak_gram_triton_op.register_kernel("cuda")
def _cuda(u1, u2, c1, c2, extra, logb, sig2, depth):
    global LAUNCHES
    inputs = (u1, u2, c1, c2, extra, logb, sig2)
    if u1.shape[1] == 0 or u2.shape[1] == 0:
        og._check_cuda_inputs(inputs, depth)
        return u1.new_empty((u1.shape[1], u2.shape[1]))
    with torch.cuda.device(u1.device):
        out = _launch(inputs, depth, traced=False)
    LAUNCHES += 1
    profiling.count("k1_triton.launches")
    return out


@oak_gram_triton_op.register_kernel("cpu")
def _cpu(u1, u2, c1, c2, extra, logb, sig2, depth):
    return og.oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)
