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
For CUDA tensors the forward kernel ``csrc/oak_gram_fwd.cu`` runs behind the
registered op ``torch.ops.oak_tpu_torch.oak_gram_fwd``, so that
``torch.export`` traces it (its fake returns the [N, M] output) and an
exported predict launches the same kernel as a live one; the op's CPU
implementation is the plain version. When a gradient is taken the op runs
inside ``FusedGram``, a ``torch.autograd.Function`` whose backward is the
registered op ``torch.ops.oak_tpu_torch.oak_gram_bwd`` (``csrc/oak_gram_bwd.cu``).
Both ops have a ``torch.func.vmap`` rule: the lanes of a multistart, vmapped
over the loss, run each kernel once for all of them, through the kernels'
lane axis (as ``jax.vmap`` prepends a grid axis to a ``pallas_call``). A CUDA
input launches a kernel or raises; nothing falls back. The forward saves
only the prescaled inputs, and the backward recomputes the per-dim grams
(``oak_tpu`` measured that storing the [D, N, M] grams loses,
oak_gram_pallas.py:523-535). The prescale, the forward and the backward are
the spans ``oak.prep``, ``oak.gram.fwd`` and ``oak.gram.bwd``
(``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ..utils import profiling
from .newton_girard import newton_girard

# Launches of the forward and the backward CUDA kernel in this process; a run
# resets them to 0 and reads them afterwards to show that its path went
# through the kernels. The same launches count as ``k1.launches`` and
# ``k2.launches`` in ``utils.profiling``'s counters while a session records.
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


def _in_dim_order(parts: List[torch.Tensor], order: List[int]) -> torch.Tensor:
    """The groups' results ``parts`` [G_i, ...], whose rows belong to the
    dims ``order`` (group by group), as one stack in dim order."""
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    perm = sorted(range(len(order)), key=order.__getitem__)
    if perm != list(range(len(order))):
        out = out.index_select(0, torch.tensor(perm, device=out.device))
    return out


@profiling.spanned("oak.prep")
def _prep(oak, X: torch.Tensor, X2: torch.Tensor) -> Prepped:
    """Prescaled inputs (u1, u2, c1, c2, extra, logb, sig2) in X's dtype:
    u1, c1 [D, N]; u2, c2 [D, M]; extra [E, N, M]; logb [D]; sig2 [P + 1].

    Each group of ``kernels.stackable_groups`` is prescaled in one batched
    call; the RBF-form groups' rows and the other groups' extra grams are
    then put in dim order. The extra grams (the binary and categorical
    groups' gathers and their stack) are the span ``oak.extra``.

    Two floors keep gradients finite when a sparsity prior prunes a dim:
    var_s is floored at sqrt(tiny) before its rsqrt (with cov and var_s both
    underflowed to 0, rsqrt(0) = inf would make the downdate 0 * inf = NaN),
    and the base variance at the smallest f32 normal before its log
    (log 0 = -inf, and the 1/variance chain factor would NaN the gradient).
    """
    from ..kernels import ortho_rbf
    from ..kernels.oak_kernel import UnconstrainedRBF, kernel_K, per_group
    from ..kernels.ortho_rbf import OrthogonalRBF

    def prescale(k, col1, col2):
        col2 = col2.to(dtype)
        if not isinstance(k, (OrthogonalRBF, UnconstrainedRBF)):
            with profiling.trace_annotation("oak.extra"):
                return kernel_K(k, col1, col2).to(dtype)
        ls2 = (k.lengthscale.value.to(dtype) * _SQRT2)[:, None]
        if isinstance(k, OrthogonalRBF):
            rs = torch.rsqrt(torch.clamp_min(ortho_rbf.var_s(k).to(dtype),
                                             _RSQRT_FLOOR))[:, None]
            c1 = ortho_rbf.cov_x_s(k, col1).to(dtype) * rs
            c2 = ortho_rbf.cov_x_s(k, col2).to(dtype) * rs
        else:
            c1, c2 = torch.zeros_like(col1), torch.zeros_like(col2)
        v = k.variance.value.reshape(-1).to(dtype)
        return (col1 / ls2, col2 / ls2, c1, c2,
                torch.log(torch.clamp_min(v, _VARIANCE_FLOOR)))

    dtype, device = X.dtype, X.device
    rbf, rbf_dims, extras, extra_dims = [], [], [], []
    for idx, out in per_group(oak.kernels, X, prescale, X2):
        if isinstance(out, tuple):
            rbf.append(out)
            rbf_dims.extend(idx)
        else:
            extras.append(out)
            extra_dims.extend(idx)

    N, M = X.shape[0], X2.shape[0]
    if rbf:
        u1, u2, c1, c2, logb = (_in_dim_order(list(parts), rbf_dims)
                                for parts in zip(*rbf))
    else:
        u1 = torch.zeros((0, N), dtype=dtype, device=device)
        u2 = torch.zeros((0, M), dtype=dtype, device=device)
        c1, c2 = u1, u2
        logb = torch.zeros((0,), dtype=dtype, device=device)
    if extras:
        with profiling.trace_annotation("oak.extra"):
            extra = _in_dim_order(extras, extra_dims)
    else:
        extra = torch.zeros((0, N, M), dtype=dtype, device=device)

    if oak.share_var_across_orders:
        sig2 = torch.stack([v.value.reshape(()) for v in oak.variances]).to(dtype)
    else:
        sig2 = torch.cat([
            oak.variances[0].value.reshape(1).to(dtype),
            torch.ones(oak.max_interaction_depth, dtype=dtype, device=device)])
    return u1, u2, c1, c2, extra, logb, sig2


def oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """The same computation in plain torch, in any dtype, with autograd.
    The CPU route, and the version the CUDA kernel is checked against.
    Inputs may carry leading lane axes, which broadcast (the ops' CPU vmap
    rules run it once over [lanes, ...] inputs)."""

    def grams():
        for d in range(u1.shape[-2]):
            du = u1[..., d, :, None] - u2[..., d, None, :]
            yield (torch.exp(logb[..., d, None, None] - du * du)
                   - c1[..., d, :, None] * c2[..., d, None, :])
        for k in range(extra.shape[-3]):
            yield extra[..., k, :, :]

    e = newton_girard(grams(), depth)
    out = sig2[..., 0, None, None] * e[0]
    for n in range(1, depth + 1):
        out = out + sig2[..., n, None, None] * e[n]
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
    Needs at least one RBF-form dim, as the fused route does. Inputs may
    carry leading lane axes, as in ``oak_gram_plain``, all of the same
    length."""
    D = u1.shape[-2]
    bEs, grams = [], []
    for d in range(D):
        du = u1[..., d, :, None] - u2[..., d, None, :]
        bEs.append(torch.exp(logb[..., d, None, None] - du * du))
        grams.append(bEs[d] - c1[..., d, :, None] * c2[..., d, None, :])
    grams.extend(extra[..., k, :, :] for k in range(extra.shape[-3]))
    e = newton_girard(grams, depth)
    dsig2 = torch.stack([torch.sum(gbar * e[n], dim=(-2, -1)) for n in range(depth + 1)],
                        dim=-1)

    def T_of(g):
        h = e[0]
        W = sig2[..., 1, None, None] * e[0]
        for k in range(1, depth):
            h = e[k] - g * h
            W = W + sig2[..., k + 1, None, None] * h
        return gbar * W

    du1, du2, dc1, dc2, dlogb = [], [], [], [], []
    for d in range(D):
        T = T_of(grams[d])
        TbE = T * bEs[d]
        TbEdu = TbE * (u1[..., d, :, None] - u2[..., d, None, :])
        du1.append(-2.0 * TbEdu.sum(-1))
        du2.append(2.0 * TbEdu.sum(-2))
        dc1.append(-(T * c2[..., d, None, :]).sum(-1))
        dc2.append(-(T * c1[..., d, :, None]).sum(-2))
        dlogb.append(TbE.sum(dim=(-2, -1)))
    dextra = (torch.stack([T_of(g) for g in grams[D:]], dim=-3) if extra.shape[-3]
              else torch.zeros_like(extra))
    return (torch.stack(du1, dim=-2), torch.stack(du2, dim=-2), torch.stack(dc1, dim=-2),
            torch.stack(dc2, dim=-2), dextra, torch.stack(dlogb, dim=-1), dsig2)


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


_NAMES = ("u1", "u2", "c1", "c2", "extra", "logb", "sig2", "gbar")


def _check_cuda_inputs(inputs: Sequence[torch.Tensor], depth: int, lanes: int = 0,
                       batched: Sequence[bool] = ()) -> List[int]:
    """Checks the kernels' inputs (u1, u2, c1, c2, extra, logb, sig2[, gbar])
    and returns each one's lane stride. With ``lanes`` > 0 the inputs marked
    in ``batched`` carry a leading lane axis of that length (a lane-batched
    launch), the others are shared by every lane (stride 0)."""
    named = dict(zip(_NAMES, inputs))
    lane_of = dict(zip(_NAMES, batched if lanes else [False] * len(inputs)))
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"oak_gram_fused: {name} is on {t.device}, the "
                             "others on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"oak_gram_fused: {name} is {t.dtype}; the CUDA "
                            "kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"oak_gram_fused: {name} is not contiguous")
        if lane_of[name] and (t.dim() == 0 or t.shape[0] != lanes):
            raise ValueError(f"oak_gram_fused: {name} has shape {tuple(t.shape)}, "
                             f"expected {lanes} lanes first")
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("oak_gram_fused: inputs lie on different devices")
    shape = {name: tuple(t.shape[1:] if lane_of[name] else t.shape)
             for name, t in named.items()}
    if len(shape["u1"]) != 2 or len(shape["u2"]) != 2:
        raise ValueError("oak_gram_fused: u1 and u2 must be 2-D [D, N], [D, M]")
    D, N = shape["u1"]
    M = shape["u2"][1]
    E = shape["extra"][0] if len(shape["extra"]) == 3 else -1
    if depth < 1 or clamped_depth(depth, D, max(E, 0)) > MAX_DEPTH:
        raise ValueError(f"oak_gram_fused: depth {depth} over {D} + {max(E, 0)} grams; "
                         f"the CUDA kernels take depths 1.. with min(depth, grams) "
                         f"<= {MAX_DEPTH}")
    expected = dict(u2=(D, M), c1=(D, N), c2=(D, M), extra=(E, N, M),
                    logb=(D,), sig2=(depth + 1,), gbar=(N, M))
    for name in named:
        if name in expected and shape[name] != expected[name]:
            raise ValueError(f"oak_gram_fused: {name} has shape "
                             f"{shape[name]}, expected {expected[name]}")
    return [math.prod(shape[name]) if lane_of[name] else 0 for name in named]


def clamped_depth(depth: int, D: int, E: int) -> int:
    """The depth the kernels run: e_n of D + E grams is exactly 0 for
    n > D + E, so deeper orders add nothing (at least 1)."""
    return max(1, min(depth, D + E))


def pick_tile(N: int, M: int, tiles: Sequence[Tuple[int, int]], sms: int,
              lanes: int = 1) -> int:
    """Index into ``tiles`` ((rows, columns) per block, largest first) of the
    first tile whose grid over ``lanes`` [N, M] outputs has at least ``sms``
    blocks, so that every SM gets one; the last (smallest) when none has."""
    for k, (bn, bm) in enumerate(tiles):
        if lanes * -(-N // bn) * -(-M // bm) >= sms:
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


def _variant(entry: str, P: int, N: int, M: int, device: torch.device,
             lanes: int = 1) -> int:
    return pick_tile(N, M, _tiles(entry, P), _sm_count(device), lanes)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides(strides: Sequence[int]):
    return (ctypes.c_longlong * len(strides))(*strides)


def _launch_fwd(inputs: Sequence[torch.Tensor], depth: int, lanes: int = 0,
                batched: Sequence[bool] = ()) -> torch.Tensor:
    """``oak_gram_fwd_f32`` at the clamped depth and the tile ``pick_tile``
    chooses, after ``_check_cuda_inputs``: the gram [N, M], or with
    ``lanes`` > 0 the lane-batched grams [lanes, N, M] in one launch."""
    global LAUNCHES
    strides = _check_cuda_inputs(inputs, depth, lanes, batched)
    u1, u2, c1, c2, extra, logb, sig2 = inputs
    (D, N), M = u1.shape[-2:], u2.shape[-1]
    E = extra.shape[-3]
    L = max(lanes, 1)
    out = torch.empty(((lanes,) if lanes else ()) + (N, M), dtype=torch.float32,
                      device=u1.device)
    if N == 0 or M == 0:
        return out
    P = clamped_depth(depth, D, E)
    variant = _variant("oak_gram_fwd_tile", P, N, M, u1.device, L)
    lib = _build.library()
    with torch.cuda.device(u1.device):
        rc = lib.oak_gram_fwd_f32(
            u1.data_ptr(), u2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            extra.data_ptr(), logb.data_ptr(), sig2.data_ptr(), out.data_ptr(),
            D, N, M, E, P, variant, L, _strides(strides), _stream(u1))
    if rc != 0:
        raise RuntimeError(f"oak_gram_fwd_f32 launch failed with cudaError {rc}")
    LAUNCHES += 1
    profiling.count("k1.launches")
    _count_extra(E * L)
    return out


def _count_extra(grams: int) -> None:
    """The counter ``gram.extra``: extra grams handed to one K1 launch (E a
    lane), or to its plain version on the CPU; nothing for E = 0."""
    if grams:
        profiling.count("gram.extra", grams)


@torch.library.custom_op("oak_tpu_torch::oak_gram_fwd", mutates_args=(),
                         device_types="cuda")
def oak_gram_fwd_op(u1: torch.Tensor, u2: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, extra: torch.Tensor, logb: torch.Tensor,
                    sig2: torch.Tensor, depth: int) -> torch.Tensor:
    """The gram [N, M] as a registered op: on CUDA tensors the forward
    kernel (checked, then launched; ``LAUNCHES`` counts it), on CPU tensors
    ``oak_gram_plain``. No autograd of its own: ``FusedGram`` gives it one.
    Under ``torch.func.vmap`` its rule launches the kernel once for every
    lane."""
    return _launch_fwd((u1, u2, c1, c2, extra, logb, sig2), depth)


@oak_gram_fwd_op.register_kernel("cpu")
def _oak_gram_fwd_cpu(u1, u2, c1, c2, extra, logb, sig2, depth):
    _count_extra(extra.shape[0])
    return oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)


@oak_gram_fwd_op.register_fake
def _oak_gram_fwd_fake(u1, u2, c1, c2, extra, logb, sig2, depth):
    return u1.new_empty((u1.shape[1], u2.shape[1]))


def _lanes_first(inputs, in_dims, lanes: int = 0):
    """The batched inputs with their lane axis moved first, contiguous; the
    others as given, or, with ``lanes``, expanded to that many (a view)."""
    return tuple((t.expand(lanes, *t.shape) if lanes else t) if d is None
                 else t.movedim(d, 0).contiguous() for t, d in zip(inputs, in_dims))


@oak_gram_fwd_op.register_vmap
def _oak_gram_fwd_vmap(info, in_dims, u1, u2, c1, c2, extra, logb, sig2, depth):
    """The lanes' grams [lanes, N, M]: one lane-batched launch of the
    forward kernel on CUDA, the plain version over the lane axis (one call)
    on the CPU."""
    inputs, dims = (u1, u2, c1, c2, extra, logb, sig2), tuple(in_dims[:7])
    if not any(t.is_cuda for t in inputs):
        inputs = _lanes_first(inputs, dims, info.batch_size)
        _count_extra(math.prod(inputs[4].shape[:-2]))
        return oak_gram_plain(*inputs, depth), 0
    return _launch_fwd(_lanes_first(inputs, dims), depth, info.batch_size,
                       [d is not None for d in dims]), 0


def _launch_bwd(inputs: Sequence[torch.Tensor], depth: int, with_dextra: bool,
                lanes: int = 0, batched: Sequence[bool] = ()) -> Grads:
    """``oak_gram_bwd_f32`` after ``_check_cuda_inputs``: the tile kernel
    writes per-tile partials into a workspace whose size the library
    reports, and its second kernel sums them in a fixed order. With
    ``lanes`` > 0 every cotangent carries a leading lane axis, all lanes in
    one launch. dextra is an empty placeholder without ``with_dextra``."""
    global BWD_LAUNCHES
    strides = _check_cuda_inputs(inputs, depth, lanes, batched)
    u1, u2, c1, c2, extra, logb, sig2, gbar = inputs
    (D, N), M = u1.shape[-2:], u2.shape[-1]
    E = extra.shape[-3]
    L = max(lanes, 1)
    lead = (lanes,) if lanes else ()
    kw = dict(dtype=torch.float32, device=u1.device)
    dextra = (torch.empty(lead + (E, N, M), **kw) if with_dextra
              else torch.empty((0,), **kw))
    if N == 0 or M == 0:
        zeros = [torch.zeros(lead + shape, **kw)
                 for shape in ((D, N), (D, M), (D, N), (D, M))]
        return (*zeros, dextra.zero_(), torch.zeros(lead + (D,), **kw),
                torch.zeros(lead + (depth + 1,), **kw))
    P = clamped_depth(depth, D, E)
    variant = _variant("oak_gram_bwd_tile", P, N, M, u1.device, L)
    lib = _build.library()
    floats = lib.oak_gram_bwd_workspace(D, N, M, P, variant, L)
    if floats < 0:
        raise RuntimeError(f"oak_gram_bwd_workspace refused depth {P}, {L} lanes")
    work = torch.empty((floats,), **kw)
    du1, dc1 = torch.empty(lead + (D, N), **kw), torch.empty(lead + (D, N), **kw)
    du2, dc2 = torch.empty(lead + (D, M), **kw), torch.empty(lead + (D, M), **kw)
    dlogb = torch.empty(lead + (D,), **kw)
    dsig2 = torch.empty(lead + (P + 1,), **kw)
    with torch.cuda.device(u1.device):
        rc = lib.oak_gram_bwd_f32(
            u1.data_ptr(), u2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            extra.data_ptr(), logb.data_ptr(), sig2.data_ptr(), gbar.data_ptr(),
            work.data_ptr(), du1.data_ptr(), dc1.data_ptr(), du2.data_ptr(),
            dc2.data_ptr(), dlogb.data_ptr(), dsig2.data_ptr(),
            dextra.data_ptr() if with_dextra else None,
            D, N, M, E, P, variant, L, _strides(strides), _stream(u1))
    if rc != 0:
        raise RuntimeError(f"oak_gram_bwd_f32 launch failed with cudaError {rc}")
    BWD_LAUNCHES += 1
    profiling.count("k2.launches")
    if P < depth:
        # orders above the clamped depth have e_n = 0, so their cotangent is 0
        dsig2 = torch.nn.functional.pad(dsig2, (0, depth - P))
    return du1, du2, dc1, dc2, dextra, dlogb, dsig2


@torch.library.custom_op("oak_tpu_torch::oak_gram_bwd", mutates_args=(),
                         device_types="cuda")
def oak_gram_bwd_op(u1: torch.Tensor, u2: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, extra: torch.Tensor, logb: torch.Tensor,
                    sig2: torch.Tensor, gbar: torch.Tensor, depth: int,
                    with_dextra: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The cotangents (du1, du2, dc1, dc2, dextra, dlogb, dsig2) of the gram
    for ``gbar`` as a registered op: on CUDA tensors the backward kernel
    (``BWD_LAUNCHES`` counts it), on CPU tensors ``oak_gram_bwd_plain``;
    dextra is an empty placeholder without ``with_dextra``. Under
    ``torch.func.vmap`` its rule launches the kernel once for every lane."""
    return _launch_bwd((u1, u2, c1, c2, extra, logb, sig2, gbar), depth, with_dextra)


def _bwd_plain(u1, u2, c1, c2, extra, logb, sig2, gbar, depth, with_dextra):
    grads = oak_gram_bwd_plain(u1, u2, c1, c2, extra, logb, sig2, gbar, depth)
    return grads if with_dextra else grads[:4] + (extra.new_empty((0,)),) + grads[5:]


@oak_gram_bwd_op.register_kernel("cpu")
def _oak_gram_bwd_cpu(u1, u2, c1, c2, extra, logb, sig2, gbar, depth, with_dextra):
    return _bwd_plain(u1, u2, c1, c2, extra, logb, sig2, gbar, depth, with_dextra)


@oak_gram_bwd_op.register_vmap
def _oak_gram_bwd_vmap(info, in_dims, u1, u2, c1, c2, extra, logb, sig2, gbar, depth,
                       with_dextra):
    """The lanes' cotangents, each [lanes, ...]: one lane-batched launch of
    the backward kernel on CUDA, the plain version over the lane axis (one
    call) on the CPU."""
    inputs, dims = (u1, u2, c1, c2, extra, logb, sig2, gbar), tuple(in_dims[:8])
    out_dims = (0, 0, 0, 0, 0 if with_dextra else None, 0, 0)
    if not any(t.is_cuda for t in inputs):
        return _bwd_plain(*_lanes_first(inputs, dims, info.batch_size), depth,
                          with_dextra), out_dims
    return _launch_bwd(_lanes_first(inputs, dims), depth, with_dextra, info.batch_size,
                       [d is not None for d in dims]), out_dims


def oak_gram_bwd(u1, u2, c1, c2, extra, logb, sig2, gbar, depth: int,
                 with_dextra: bool = True) -> Grads:
    """The cotangents (du1, du2, dc1, dc2, dextra, dlogb, dsig2) of the gram
    for the output cotangent ``gbar`` [N, M]; dextra is None when
    ``with_dextra`` is False (it is [E, N, M]).

    The registered op ``oak_gram_bwd_op``: CPU tensors go to
    ``oak_gram_bwd_plain``. CUDA tensors launch ``oak_gram_bwd_f32`` from
    ``csrc/oak_gram_bwd.cu``, or raise, under the forward's conditions;
    gbar is made contiguous first."""
    grads = oak_gram_bwd_op(u1, u2, c1, c2, extra, logb, sig2, gbar.contiguous(), depth,
                            with_dextra)
    return grads if with_dextra else grads[:4] + (None,) + grads[5:]


class FusedGram(torch.autograd.Function):
    """The gram with a recompute backward: the forward saves only the
    prescaled inputs, never the [D, N, M] grams, and the backward
    recomputes them (``oak_tpu``'s ``_gram_op``, oak_gram_pallas.py:497-569).
    The forward is the registered op (the forward kernel on CUDA), the
    backward the registered backward op (the backward kernel); on the CPU
    they are the two plain versions.

    It composes with ``torch.func``: ``setup_context`` lets ``grad`` take
    it, and under ``vmap`` the generated rule runs forward and backward on
    the lane-batched tensors, so each op's own vmap rule launches its
    kernel once for every lane. The backward is not differentiable
    again."""

    generate_vmap_rule = True

    @staticmethod
    def forward(u1, u2, c1, c2, extra, logb, sig2, depth):
        return oak_gram_fwd_op(u1, u2, c1, c2, extra, logb, sig2, depth)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *saved, depth = inputs
        ctx.depth = depth
        ctx.save_for_backward(*saved)

    @staticmethod
    def backward(ctx, gbar):
        need = ctx.needs_input_grad[:7]
        # under no_grad the backward op runs below autograd (torch.func's
        # grad runs backward with create_graph)
        with torch.no_grad(), profiling.trace_annotation("oak.gram.bwd"):
            grads = oak_gram_bwd(*ctx.saved_tensors, gbar, ctx.depth, with_dextra=need[4])
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """The OAK gram [N, M] from prescaled inputs (see ``_prep``).

    CPU tensors go to ``oak_gram_plain`` (with autograd). CUDA tensors go
    to the registered op, the forward kernel ``oak_gram_fwd_f32``, inside
    ``FusedGram`` when a gradient is taken (the backward kernel
    ``oak_gram_bwd_f32``), or raise. They must be float32, contiguous, on
    one device, of consistent shapes, with depth >= 1 and
    ``clamped_depth(depth, D, E) <= MAX_DEPTH``. Under ``torch.func.vmap``
    over lanes each kernel launches once for all of them."""
    inputs = (u1, u2, c1, c2, extra, logb, sig2)
    if not any(t.is_cuda for t in inputs):
        with profiling.trace_annotation("oak.gram.fwd"):
            return oak_gram_plain(*inputs, depth)
    return fused_op(inputs, depth)


def fused_op(inputs: Sequence[torch.Tensor], depth: int) -> torch.Tensor:
    """The registered op on the prescaled inputs, inside ``FusedGram``
    where a gradient may be taken through it: grad mode is on and an input
    requires grad or is batched by ``torch.func.vmap``. Under vmap, a grad
    or vjp taken outside the vmap does not show in ``requires_grad``
    (``parallel.mesh.MeshLoss``'s lanes form takes the vjp of its vmapped
    local terms); ``FusedGram`` composes with both orders. The batched
    check is functorch's private ``is_batchedtensor`` (torch 2.11 and
    2.13). Were it to read False under vmap, the registered op would run
    with no autograd and the local gradient would vanish:
    ``tests/test_torch_sharding.py::test_lanes_form_runs_each_gram_once_for_all_lanes``
    (K2 entered as often as for one lane, the gradient as in turn) and
    ``chip_smoke.py``'s phase 12 (batched against in turn on the card)
    fail then."""
    with profiling.trace_annotation("oak.gram.fwd"):
        if torch.is_grad_enabled() and any(
                t.requires_grad or torch._C._functorch.is_batchedtensor(t) for t in inputs):
            return FusedGram.apply(*inputs, depth)
        return oak_gram_fwd_op(*inputs, depth)


def oak_gram(oak, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The OAK gram of ``oak`` through the fused op; dtype follows X."""
    X2_ = X if X2 is None else X2
    u1, u2, c1, c2, extra, logb, sig2 = _prep(oak, X, X2_)
    out = oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2,
                         oak.max_interaction_depth)
    return out.to(X.dtype)
