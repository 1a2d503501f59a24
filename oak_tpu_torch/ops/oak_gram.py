"""The fused OAK gram: prescaled inputs, the plain torch versions of the
gram and of its backward, and the wrappers that launch the CUDA kernels
``csrc/oak_gram_fwd.cu`` and ``csrc/oak_gram_bwd.cu``.

For inputs X [N, D], X2 [M, D] the OAK gram is

    K = Σ_n σ²_n e_n(g_1, ..., g_D),
    g_d = b_d exp(-(x_d - x'_d)² / (2 l_d²)) - cov_d(x) cov_d(x') / var_s_d.

``_prep`` folds the constants into the inputs (as ``oak_tpu``'s does), so
that each (element, dim) costs one exp and a few FMAs:

    u = x / (l √2),   logb = log b,   c = cov(x) / √var_s
    g = exp(logb - (u - u')²) - c c'

Dims that are not RBF-form (binary, categorical) are evaluated here as
``extra`` grams [E, N, M] that join the power sums.

``oak_gram_fused`` takes the plain version, with autograd, for CPU tensors.
For CUDA tensors it runs ``FusedGram``, a ``torch.autograd.Function`` whose
forward launches ``csrc/oak_gram_fwd.cu`` and whose backward launches
``csrc/oak_gram_bwd.cu``, or raises; it never falls back. The forward saves
only the prescaled inputs, and the backward recomputes the per-dim grams
(``oak_tpu`` measured that storing the [D, N, M] grams loses,
oak_gram_pallas.py:523-535).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from .newton_girard import newton_girard

# Launches of the forward and the backward CUDA kernel in this process; a run
# resets them to 0 and reads them afterwards to show that its path went
# through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

# Deepest clamped depth min(depth, D + E) the kernels take
# (csrc/oak_gram_common.cuh kMaxDepth): e_n of D + E grams is 0 for
# n > D + E, so a deeper model loses nothing by the clamp.
MAX_DEPTH = 64

_SQRT2 = 1.4142135623730951
_RSQRT_FLOOR = 1.0842022e-19  # sqrt of the smallest f32 normal
_VARIANCE_FLOOR = 1.1754944e-38  # the smallest f32 normal

Prepped = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor, torch.Tensor]


def _prep(oak, X: torch.Tensor, X2: torch.Tensor) -> Prepped:
    """Prescaled inputs (u1, u2, c1, c2, extra, logb, sig2) in X's dtype:
    u1, c1 [D, N]; u2, c2 [D, M]; extra [E, N, M]; logb [D]; sig2 [P + 1].

    Two floors keep gradients finite when a sparsity prior prunes a dim:
    var_s is floored at sqrt(tiny) before its rsqrt (with cov and var_s both
    underflowed to 0, rsqrt(0) = inf would make the downdate 0 * inf = NaN),
    and the base variance at the smallest f32 normal before its log
    (log 0 = -inf, and the 1/variance chain factor would NaN the gradient).
    """
    from ..kernels import ortho_rbf
    from ..kernels.oak_kernel import UnconstrainedRBF, kernel_K
    from ..kernels.ortho_rbf import OrthogonalRBF

    dtype, device = X.dtype, X.device
    us1, us2, cs1, cs2, logbs, extras = [], [], [], [], [], []
    for k in oak.kernels:
        col1 = X[:, k.active_dim]
        col2 = X2[:, k.active_dim].to(dtype)
        if isinstance(k, (OrthogonalRBF, UnconstrainedRBF)):
            ls2 = k.lengthscale.value.to(dtype) * _SQRT2
            us1.append(col1 / ls2)
            us2.append(col2 / ls2)
            if isinstance(k, OrthogonalRBF):
                rs = torch.rsqrt(torch.clamp_min(ortho_rbf.var_s(k).to(dtype),
                                                 _RSQRT_FLOOR))
                cs1.append(ortho_rbf.cov_x_s(k, col1).to(dtype) * rs)
                cs2.append(ortho_rbf.cov_x_s(k, col2).to(dtype) * rs)
            else:
                cs1.append(torch.zeros_like(col1))
                cs2.append(torch.zeros_like(col2))
            v = k.variance.value.reshape(()).to(dtype)
            logbs.append(torch.log(torch.clamp_min(v, _VARIANCE_FLOOR)))
        else:
            extras.append(kernel_K(k, col1, col2).to(dtype))

    N, M = X.shape[0], X2.shape[0]
    if us1:
        u1, u2 = torch.stack(us1), torch.stack(us2)
        c1, c2 = torch.stack(cs1), torch.stack(cs2)
        logb = torch.stack(logbs)
    else:
        u1 = torch.zeros((0, N), dtype=dtype, device=device)
        u2 = torch.zeros((0, M), dtype=dtype, device=device)
        c1, c2 = u1, u2
        logb = torch.zeros((0,), dtype=dtype, device=device)
    extra = (torch.stack(extras) if extras
             else torch.zeros((0, N, M), dtype=dtype, device=device))

    if oak.share_var_across_orders:
        sig2 = torch.stack([v.value.reshape(()) for v in oak.variances]).to(dtype)
    else:
        sig2 = torch.cat([
            oak.variances[0].value.reshape(1).to(dtype),
            torch.ones(oak.max_interaction_depth, dtype=dtype, device=device)])
    return u1, u2, c1, c2, extra, logb, sig2


def oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """The same computation in plain torch, in any dtype, with autograd.
    The CPU route, and the version the CUDA kernel is checked against."""

    def grams():
        for d in range(u1.shape[0]):
            du = u1[d, :, None] - u2[d, None, :]
            yield torch.exp(logb[d] - du * du) - c1[d, :, None] * c2[d, None, :]
        yield from extra

    e = newton_girard(grams(), depth)
    out = sig2[0] * e[0]
    for n in range(1, depth + 1):
        out = out + sig2[n] * e[n]
    return out


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor, torch.Tensor]


def oak_gram_bwd_plain(u1, u2, c1, c2, extra, logb, sig2, gbar,
                       depth: int) -> Grads:
    """The cotangents (du1, du2, dc1, dc2, dextra, dlogb, dsig2) of
    ``oak_gram_plain`` for the output cotangent ``gbar`` [N, M], written out
    in plain torch: the version the backward kernel is checked against.

    It recomputes g_d and e_n, and for each gram runs the downdate
    h_k = e_k − g·h_{k−1} (h_k is e_k of the other grams) to form
    W = Σ_{n≥1} σ²_n h_{n−1} = ∂out/∂g and T = gbar·W; with bE = g + c1·c2
    (the exp factor) and Δu = u1 − u2 the RBF-form dims give
    du1 = −2 Σ_j T·bE·Δu, du2 = 2 Σ_i T·bE·Δu, dc1 = −Σ_j T·c2,
    dc2 = −Σ_i T·c1, dlogb = Σ T·bE, the extra grams dextra = T, and
    dsig2_n = Σ gbar·e_n (oak_gram_pallas.py:158-237 and ``_res_bwd``).
    Needs at least one RBF-form dim, as the fused route does."""
    D = u1.shape[0]
    bEs, grams = [], []
    for d in range(D):
        du = u1[d, :, None] - u2[d, None, :]
        bEs.append(torch.exp(logb[d] - du * du))
        grams.append(bEs[d] - c1[d, :, None] * c2[d, None, :])
    grams.extend(extra)
    e = newton_girard(grams, depth)
    dsig2 = torch.stack([torch.sum(gbar * e[n]) for n in range(depth + 1)])

    def T_of(g):
        h = e[0]
        W = sig2[1] * e[0]
        for k in range(1, depth):
            h = e[k] - g * h
            W = W + sig2[k + 1] * h
        return gbar * W

    du1, du2, dc1, dc2, dlogb = [], [], [], [], []
    for d in range(D):
        T = T_of(grams[d])
        TbE = T * bEs[d]
        TbEdu = TbE * (u1[d, :, None] - u2[d, None, :])
        du1.append(-2.0 * TbEdu.sum(1))
        du2.append(2.0 * TbEdu.sum(0))
        dc1.append(-(T * c2[d, None, :]).sum(1))
        dc2.append(-(T * c1[d, :, None]).sum(0))
        dlogb.append(TbE.sum())
    dextra = (torch.stack([T_of(g) for g in grams[D:]]) if extra.shape[0]
              else torch.zeros_like(extra))
    return (torch.stack(du1), torch.stack(du2), torch.stack(dc1), torch.stack(dc2),
            dextra, torch.stack(dlogb), dsig2)


def supports_fused(oak) -> bool:
    """Structure check: at least one RBF-form dim (any measure, or the
    unconstrained variant), and every other dim binary or categorical
    (through ``extra``). Depth is not part of it, as in ``oak_tpu``'s
    ``supports_pallas``: ``oak_gram_fused`` takes any depth whose clamp to
    the number of grams is at most MAX_DEPTH, and raises above."""
    from ..kernels.oak_kernel import UnconstrainedRBF
    from ..kernels.ortho_binary import OrthogonalBinary
    from ..kernels.ortho_categorical import OrthogonalCategorical
    from ..kernels.ortho_rbf import OrthogonalRBF

    rbf_types = (OrthogonalRBF, UnconstrainedRBF)
    known = all(isinstance(k, rbf_types + (OrthogonalBinary, OrthogonalCategorical))
                for k in oak.kernels)
    n_rbf = sum(isinstance(k, rbf_types) for k in oak.kernels)
    return known and n_rbf > 0


def _check_cuda_inputs(u1, u2, c1, c2, extra, logb, sig2, depth: int,
                       gbar: Optional[torch.Tensor] = None) -> None:
    named = dict(u1=u1, u2=u2, c1=c1, c2=c2, extra=extra, logb=logb, sig2=sig2)
    if gbar is not None:
        named["gbar"] = gbar
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"oak_gram_fused: {name} is on {t.device}, the "
                             "others on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"oak_gram_fused: {name} is {t.dtype}; the CUDA "
                            "kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"oak_gram_fused: {name} is not contiguous")
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("oak_gram_fused: inputs lie on different devices")
    if u1.dim() != 2 or u2.dim() != 2:
        raise ValueError("oak_gram_fused: u1 and u2 must be 2-D [D, N], [D, M]")
    D, N = u1.shape
    M = u2.shape[1]
    E = extra.shape[0] if extra.dim() == 3 else -1
    if depth < 1 or clamped_depth(depth, D, max(E, 0)) > MAX_DEPTH:
        raise ValueError(f"oak_gram_fused: depth {depth} over {D} + {max(E, 0)} grams; "
                         f"the CUDA kernels take depths 1.. with min(depth, grams) "
                         f"<= {MAX_DEPTH}")
    expected = dict(u2=(D, M), c1=(D, N), c2=(D, M), extra=(E, N, M),
                    logb=(D,), sig2=(depth + 1,), gbar=(N, M))
    for name, t in named.items():
        if name in expected and tuple(t.shape) != expected[name]:
            raise ValueError(f"oak_gram_fused: {name} has shape "
                             f"{tuple(t.shape)}, expected {expected[name]}")


def clamped_depth(depth: int, D: int, E: int) -> int:
    """The depth the kernels run: e_n of D + E grams is exactly 0 for
    n > D + E, so deeper orders add nothing (at least 1)."""
    return max(1, min(depth, D + E))


def pick_tile(N: int, M: int, tiles: Sequence[Tuple[int, int]], sms: int) -> int:
    """Index into ``tiles`` ((rows, columns) per block, largest first) of the
    first tile whose grid over an [N, M] output has at least ``sms`` blocks,
    so that every SM gets one; the last (smallest) when none has."""
    for k, (bn, bm) in enumerate(tiles):
        if -(-N // bn) * -(-M // bm) >= sms:
            return k
    return len(tiles) - 1


@functools.lru_cache(maxsize=None)
def _tiles(entry: str, P: int) -> Tuple[Tuple[int, int], ...]:
    """The (rows, columns) block tiles of variants 0 and 1 that the library
    entry point ``entry`` reports for clamped depth P."""
    fn = getattr(_build.library(), entry)
    out = []
    for variant in (0, 1):
        bn, bm = ctypes.c_int(), ctypes.c_int()
        rc = fn(P, variant, ctypes.byref(bn), ctypes.byref(bm))
        if rc != 0:
            raise RuntimeError(f"{entry}({P}, {variant}) failed with cudaError {rc}")
        out.append((bn.value, bm.value))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _variant(entry: str, P: int, N: int, M: int, device: torch.device) -> int:
    return pick_tile(N, M, _tiles(entry, P), _sm_count(device))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """``oak_gram_fwd_f32`` on inputs ``_check_cuda_inputs`` accepted, at
    the clamped depth and the tile ``pick_tile`` chooses."""
    global LAUNCHES
    D, N = u1.shape
    M, E = u2.shape[1], extra.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=u1.device)
    if N == 0 or M == 0:
        return out
    P = clamped_depth(depth, D, E)
    variant = _variant("oak_gram_fwd_tile", P, N, M, u1.device)
    lib = _build.library()
    with torch.cuda.device(u1.device):
        rc = lib.oak_gram_fwd_f32(
            u1.data_ptr(), u2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            extra.data_ptr(), logb.data_ptr(), sig2.data_ptr(), out.data_ptr(),
            D, N, M, E, P, variant, _stream(u1))
    if rc != 0:
        raise RuntimeError(f"oak_gram_fwd_f32 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out


def _launch_bwd(u1, u2, c1, c2, extra, logb, sig2, gbar, depth: int,
                with_dextra: bool) -> Grads:
    """``oak_gram_bwd_f32`` on inputs ``_check_cuda_inputs`` accepted: the
    tile kernel writes per-tile partials into a workspace whose size the
    library reports, and its second kernel sums them in a fixed order."""
    global BWD_LAUNCHES
    D, N = u1.shape
    M, E = u2.shape[1], extra.shape[0]
    dextra = torch.empty_like(extra) if with_dextra else None
    if N == 0 or M == 0:
        return (torch.zeros_like(u1), torch.zeros_like(u2), torch.zeros_like(c1),
                torch.zeros_like(c2), None if dextra is None else dextra.zero_(),
                torch.zeros_like(logb), torch.zeros_like(sig2))
    P = clamped_depth(depth, D, E)
    variant = _variant("oak_gram_bwd_tile", P, N, M, u1.device)
    lib = _build.library()
    floats = lib.oak_gram_bwd_workspace(D, N, M, P, variant)
    if floats < 0:
        raise RuntimeError(f"oak_gram_bwd_workspace refused depth {P}")
    kw = dict(dtype=torch.float32, device=u1.device)
    work = torch.empty((floats,), **kw)
    du1, dc1 = torch.empty((D, N), **kw), torch.empty((D, N), **kw)
    du2, dc2 = torch.empty((D, M), **kw), torch.empty((D, M), **kw)
    dlogb = torch.empty((D,), **kw)
    # orders above the clamped depth have e_n = 0, so their cotangent is 0
    dsig2 = (torch.empty if P == depth else torch.zeros)((depth + 1,), **kw)
    with torch.cuda.device(u1.device):
        rc = lib.oak_gram_bwd_f32(
            u1.data_ptr(), u2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            extra.data_ptr(), logb.data_ptr(), sig2.data_ptr(), gbar.data_ptr(),
            work.data_ptr(), du1.data_ptr(), dc1.data_ptr(), du2.data_ptr(),
            dc2.data_ptr(), dlogb.data_ptr(), dsig2.data_ptr(),
            None if dextra is None else dextra.data_ptr(),
            D, N, M, E, P, variant, _stream(u1))
    if rc != 0:
        raise RuntimeError(f"oak_gram_bwd_f32 launch failed with cudaError {rc}")
    BWD_LAUNCHES += 1
    return du1, du2, dc1, dc2, dextra, dlogb, dsig2


def oak_gram_bwd(u1, u2, c1, c2, extra, logb, sig2, gbar, depth: int,
                 with_dextra: bool = True) -> Grads:
    """The cotangents (du1, du2, dc1, dc2, dextra, dlogb, dsig2) of the gram
    for the output cotangent ``gbar`` [N, M]; dextra is None when
    ``with_dextra`` is False (it is [E, N, M]).

    CPU tensors go to ``oak_gram_bwd_plain``. CUDA tensors launch
    ``oak_gram_bwd_f32`` from ``csrc/oak_gram_bwd.cu``, or raise, under the
    forward's conditions; gbar is made contiguous first."""
    inputs = (u1, u2, c1, c2, extra, logb, sig2, gbar)
    if not any(t.is_cuda for t in inputs):
        grads = oak_gram_bwd_plain(*inputs, depth)
        return grads if with_dextra else grads[:4] + (None,) + grads[5:]
    gbar = gbar.contiguous()
    _check_cuda_inputs(u1, u2, c1, c2, extra, logb, sig2, depth, gbar)
    return _launch_bwd(u1, u2, c1, c2, extra, logb, sig2, gbar, depth, with_dextra)


class FusedGram(torch.autograd.Function):
    """The gram with a recompute backward: the forward saves only the
    prescaled inputs, never the [D, N, M] grams, and the backward
    recomputes them (``oak_tpu``'s ``_gram_op``, oak_gram_pallas.py:497-569).
    On CUDA the forward launches the forward kernel and the backward the
    backward kernel; on the CPU they are the two plain versions."""

    @staticmethod
    def forward(ctx, u1, u2, c1, c2, extra, logb, sig2, depth):
        ctx.depth = depth
        ctx.save_for_backward(u1, u2, c1, c2, extra, logb, sig2)
        if not any(t.is_cuda for t in (u1, u2, c1, c2, extra, logb, sig2)):
            return oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)
        _check_cuda_inputs(u1, u2, c1, c2, extra, logb, sig2, depth)
        return _launch_fwd(u1, u2, c1, c2, extra, logb, sig2, depth)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        need = ctx.needs_input_grad[:7]
        grads = oak_gram_bwd(*ctx.saved_tensors, gbar, ctx.depth,
                             with_dextra=need[4])
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """The OAK gram [N, M] from prescaled inputs (see ``_prep``).

    CPU tensors go to ``oak_gram_plain`` (with autograd). CUDA tensors go
    through ``FusedGram``: the forward kernel ``oak_gram_fwd_f32`` and, when
    a gradient is taken, the backward kernel ``oak_gram_bwd_f32``, or raise.
    They must be float32, contiguous, on one device, of consistent shapes,
    with depth >= 1 and ``clamped_depth(depth, D, E) <= MAX_DEPTH``."""
    if not any(t.is_cuda for t in (u1, u2, c1, c2, extra, logb, sig2)):
        return oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)
    return FusedGram.apply(u1, u2, c1, c2, extra, logb, sig2, depth)


def oak_gram(oak, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The OAK gram of ``oak`` through the fused op; dtype follows X."""
    X2_ = X if X2 is None else X2
    u1, u2, c1, c2, extra, logb, sig2 = _prep(oak, X, X2_)
    out = oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2,
                         oak.max_interaction_depth)
    return out.to(X.dtype)
