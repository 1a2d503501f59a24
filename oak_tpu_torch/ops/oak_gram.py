"""The fused OAK gram: prescaled inputs, the plain torch version, and the
wrapper that launches the CUDA kernel ``csrc/oak_gram_fwd.cu``.

For inputs X [N, D], X2 [M, D] the OAK gram is

    K = Σ_n σ²_n e_n(g_1, ..., g_D),
    g_d = b_d exp(-(x_d - x'_d)² / (2 l_d²)) - cov_d(x) cov_d(x') / var_s_d.

``_prep`` folds the constants into the inputs (as ``oak_tpu``'s does), so
that each (element, dim) costs one exp and a few FMAs:

    u = x / (l √2),   logb = log b,   c = cov(x) / √var_s
    g = exp(logb - (u - u')²) - c c'

Dims that are not RBF-form (binary, categorical) are evaluated here as
``extra`` grams [E, N, M] that join the power sums.

``oak_gram_fused`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises; it never falls back. It has no backward
kernel yet, so on CUDA it refuses inputs that require grad.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .newton_girard import newton_girard

# Launches of the CUDA kernel in this process; a run resets it to 0 and reads
# it afterwards to show that its path went through the kernel.
LAUNCHES = 0

# Deepest interaction order the kernel is instantiated for (csrc dispatch).
MAX_DEPTH = 8

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


def supports_fused(oak) -> bool:
    """Structure check: at least one RBF-form dim (any measure, or the
    unconstrained variant), and every other dim binary or categorical
    (through ``extra``). Depth is not part of it: a CUDA model deeper than
    MAX_DEPTH reaches ``oak_gram_fused``, which raises (ROADMAP K1-P8)."""
    from ..kernels.oak_kernel import UnconstrainedRBF
    from ..kernels.ortho_binary import OrthogonalBinary
    from ..kernels.ortho_categorical import OrthogonalCategorical
    from ..kernels.ortho_rbf import OrthogonalRBF

    rbf_types = (OrthogonalRBF, UnconstrainedRBF)
    known = all(isinstance(k, rbf_types + (OrthogonalBinary, OrthogonalCategorical))
                for k in oak.kernels)
    n_rbf = sum(isinstance(k, rbf_types) for k in oak.kernels)
    return known and n_rbf > 0


def _check_cuda_inputs(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> None:
    named = dict(u1=u1, u2=u2, c1=c1, c2=c2, extra=extra, logb=logb, sig2=sig2)
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
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"oak_gram_fused: depth {depth} is outside 1..{MAX_DEPTH}, "
                         f"the depths the CUDA kernel is built for (ROADMAP K1-P8)")
    if u1.dim() != 2 or u2.dim() != 2:
        raise ValueError("oak_gram_fused: u1 and u2 must be 2-D [D, N], [D, M]")
    D, N = u1.shape
    M = u2.shape[1]
    E = extra.shape[0] if extra.dim() == 3 else -1
    expected = dict(u2=(D, M), c1=(D, N), c2=(D, M), extra=(E, N, M),
                    logb=(D,), sig2=(depth + 1,))
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"oak_gram_fused: {name} has shape "
                             f"{tuple(named[name].shape)}, expected {shape}")


def oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2, depth: int) -> torch.Tensor:
    """The OAK gram [N, M] from prescaled inputs (see ``_prep``).

    CPU tensors go to ``oak_gram_plain`` (with autograd). CUDA tensors launch
    ``oak_gram_fwd_f32`` from ``csrc/oak_gram_fwd.cu``, or raise: they must be
    float32, contiguous, on one device, of consistent shapes, with
    1 <= depth <= MAX_DEPTH, and must not require grad (the backward kernel is
    ROADMAP item K2; call under ``torch.no_grad()``)."""
    global LAUNCHES
    inputs = (u1, u2, c1, c2, extra, logb, sig2)
    if not any(t.is_cuda for t in inputs):
        return oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, depth)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "oak_gram_fused has no backward on CUDA yet (ROADMAP item K2, the "
            "gram backward kernel); run the CUDA gram under torch.no_grad()")
    _check_cuda_inputs(u1, u2, c1, c2, extra, logb, sig2, depth)
    D, N = u1.shape
    M, E = u2.shape[1], extra.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=u1.device)
    if N == 0 or M == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream(u1.device).cuda_stream
        rc = lib.oak_gram_fwd_f32(
            u1.data_ptr(), u2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            extra.data_ptr(), logb.data_ptr(), sig2.data_ptr(), out.data_ptr(),
            D, N, M, E, depth, stream)
    if rc != 0:
        raise RuntimeError(f"oak_gram_fwd_f32 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out


def oak_gram(oak, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The OAK gram of ``oak`` through the fused op; dtype follows X."""
    X2_ = X if X2 is None else X2
    u1, u2, c1, c2, extra, logb, sig2 = _prep(oak, X, X2_)
    out = oak_gram_fused(u1, u2, c1, c2, extra, logb, sig2,
                         oak.max_interaction_depth)
    return out.to(X.dtype)
