"""Analytic Sobol indices and per-component predictions (``oak_tpu.sobol``).

For each additive component c with dims S and posterior weights alpha, the
unnormalised Sobol index is

    R_c = alphaᵀ (∏_{d ∈ S} L_d) alpha        (Hadamard product)

with L_d[i, j] = ∫ K_d(x_i, s) K_d(x_j, s) dμ_d(s) the per-dim second-moment
matrix under dim d's measure: the closed form f1 - f2 - f3 + f4 for a Gaussian
measure (paper App. G.1), Kxuᵀ diag(w) Kxu for an empirical one, B_x diag(p)
B_xᵀ for binary and categorical dims, and Gauss–Hermite (MOG) or
Gauss–Legendre (uniform) quadrature, L = G diag(w) Gᵀ with G = K(x, grid).

Orders 1 and 2 use the factor form L_d = F diag(w) Fᵀ when every dim has a
well-conditioned one: sums of non-negative terms instead of O(N²) signed
products. Higher orders, and every order when some dim has no usable factor,
take a prefix ladder of GEMMs over the flattened L stack (``_ladder_quadforms``).

In shared-variance mode a component's value is scaled by variances[order]²;
otherwise the base variances are inside each L.

The quadratic forms are GEMMs, einsums and elementwise products in torch, as
``oak_tpu`` computes them outside any Pallas kernel; the CUDA kernels serve
the grams that give alpha.

``mesh=`` (a ``DeviceMesh``; its first axis) shards the O(N²) work over
processes, as ``oak_tpu`` shards its intermediates: each rank builds its
block of rows of the L stack, of the factor forms and of the ladder's
prefix products, and the partial sums the values are made of (the factor
forms' contractions, the per-order value vectors) are all-reduced. alpha
(for a GPR, through its [N, N] Cholesky) is computed on every rank. For
components, the rows of X are split and the blocks gathered.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .bijectors import Exp, Sigmoid, Softplus
from .kernels import ortho_binary, ortho_categorical, ortho_rbf
from .kernels.oak_kernel import (OAKKernel, component_index_tuples, kernel_K,
                                 per_group)
from .kernels.ortho_binary import OrthogonalBinary
from .kernels.ortho_categorical import OrthogonalCategorical, table_rows
from .kernels.ortho_rbf import OrthogonalRBF
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .ops.newton_girard import newton_girard_from_power_sums, power_sums_stacked
from .params import Param


# --------------------------------------------------------------------------- #
# Closed-form Gaussian-measure integrals (paper App. G.1 eqs 44-47)
# --------------------------------------------------------------------------- #
def f1(x, y, sigma, l, delta, mu):
    return (sigma ** 4 * l / torch.sqrt(l ** 2 + 2 * delta ** 2)
            * torch.exp(-((x - y) ** 2) / (4 * l ** 2))
            * torch.exp(-((mu - (x + y) / 2) ** 2) / (2 * delta ** 2 + l ** 2)))


def f2(x, y, sigma, l, delta, mu):
    M = 1 / l ** 2 + 1 / (l ** 2 + delta ** 2)
    m = (mu / (l ** 2 + delta ** 2) + x / l ** 2) / M
    C = x ** 2 / l ** 2 + mu ** 2 / (l ** 2 + delta ** 2) - m ** 2 * M
    return (sigma ** 4 * l * torch.sqrt((l ** 2 + 2 * delta ** 2) / (delta ** 2 * M + 1))
            * torch.exp(-C / 2) / (l ** 2 + delta ** 2)
            * torch.exp(-((y - mu) ** 2) / (2 * (l ** 2 + delta ** 2)))
            * torch.exp(-((m - mu) ** 2) / (2 * (1 / M + delta ** 2))))


def f3(x, y, sigma, l, delta, mu):
    return f2(y, x, sigma, l, delta, mu)


def f4(x, y, sigma, l, delta, mu):
    return (sigma ** 4 * l ** 2 * (l ** 2 + 2 * delta ** 2)
            * torch.sqrt((l ** 2 + delta ** 2) / (l ** 2 + 3 * delta ** 2))
            / ((l ** 2 + delta ** 2) ** 2)
            * torch.exp(-((x - mu) ** 2 + (y - mu) ** 2) / (2 * (l ** 2 + delta ** 2))))


def compute_L_gaussian(x: torch.Tensor, lengthscale, variance, delta, mu,
                       rows: slice = slice(None)) -> torch.Tensor:
    """[..., N, N] L of OrthogonalRBF dims under N(mu, delta²), by
    broadcasting (their ``rows`` only); the scalars may be floats, tensors,
    or one per dim of a group [G] with x [G, N]."""
    l, variance, delta, mu = (
        torch.as_tensor(v, dtype=x.dtype, device=x.device)[..., None, None]
        for v in (lengthscale, variance, delta, mu))
    sigma = torch.sqrt(variance)
    xi, yj = x[..., rows, None], x[..., None, :]
    return (f1(xi, yj, sigma, l, delta, mu) - f2(xi, yj, sigma, l, delta, mu)
            - f3(xi, yj, sigma, l, delta, mu) + f4(xi, yj, sigma, l, delta, mu))


# --------------------------------------------------------------------------- #
# Quadrature / matmul L matrices
# --------------------------------------------------------------------------- #
def compute_L_empirical(kernel: OrthogonalRBF, x: torch.Tensor,
                        rows: slice = slice(None)) -> torch.Tensor:
    """L = Kxuᵀ diag(w) Kxu over the empirical locations (its ``rows``)."""
    m: EmpiricalMeasure = kernel.measure
    kxu = ortho_rbf.K(kernel, m.location[..., 0], x)  # [..., E, N]
    return (m.weights * kxu[..., rows]).mT @ kxu


def _binary_p(kernel: OrthogonalBinary) -> torch.Tensor:
    return torch.stack([kernel.p0, 1.0 - kernel.p0], dim=-1)


def compute_L_binary(kernel: OrthogonalBinary, x: torch.Tensor,
                     rows: slice = slice(None)) -> torch.Tensor:
    """L = B_x diag(p) B_xᵀ with the full-variance table B (PARITY_NOTES:
    the reference scales binary components by σ² instead of σ⁴)."""
    Bx = table_rows(ortho_binary.output_covariance(kernel), x)  # [..., N, 2]
    return (Bx[..., rows, :] * _binary_p(kernel)[..., None, :]) @ Bx.mT


def compute_L_categorical(kernel: OrthogonalCategorical, x: torch.Tensor,
                          rows: slice = slice(None)) -> torch.Tensor:
    """L = B_x diag(p) B_xᵀ with B_x the gathered rows of the table."""
    Bx = table_rows(ortho_categorical.output_covariance(kernel), x)  # [..., N, C]
    return (Bx[..., rows, :] * kernel.p.mT) @ Bx.mT


def _gauss_hermite_grid(means: torch.Tensor, variances: torch.Tensor,
                        weights: torch.Tensor, num_points: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodes and weights [..., K·Q] of Q-point Gauss–Hermite under each of
    K Gaussian components [..., K], in the dtype and on the device of
    ``means``."""
    q, w = np.polynomial.hermite_e.hermegauss(num_points)
    kw = dict(dtype=means.dtype, device=means.device)
    q = torch.as_tensor(q, **kw)
    w = torch.as_tensor(w / np.sqrt(2.0 * np.pi), **kw)
    s = means[..., :, None] + torch.sqrt(variances)[..., :, None] * q  # [..., K, Q]
    return s.flatten(-2), (weights[..., :, None] * w).flatten(-2)


def compute_L_quadrature(kernel: OrthogonalRBF, x: torch.Tensor,
                         num_points: int = 64, rows: slice = slice(None)) -> torch.Tensor:
    """L = G diag(w) Gᵀ with G = K(x, grid), for any measure with a factor
    form (MOG and uniform, and Gaussian as a check on the closed form)."""
    fw = factor_form(kernel, x, num_points)
    if fw is None:
        raise NotImplementedError(type(kernel.measure))
    G, w = fw
    return (G[..., rows, :] * w[..., None, :]) @ G.mT


def compute_L_for_kernel(kernel, x: torch.Tensor, delta=None, mu=None,
                         rows: slice = slice(None)) -> torch.Tensor:
    """The L of one constituent kernel on its sliced column ``x`` [N], or of
    a stacked group (``kernels.stack_group``) on its columns [G, N]; its
    ``rows`` only (a shard's block, all columns) when given.

    A Gaussian measure takes the closed form for l <= 0.5·δ and 64-point
    Gauss–Hermite quadrature above: the closed form's four terms are each
    ~σ⁴ and cancel once l exceeds the measure's scale, while quadrature is
    exact there and only fails for l far below the node spacing. Both are
    evaluated and one selected with ``torch.where``; the unused closed form
    may hold inf or NaN at large l, which the selection drops (no gradient
    flows through Sobol). ``delta`` (a standard deviation) and ``mu``
    override the kernel's own measure."""
    if isinstance(kernel, OrthogonalBinary):
        return compute_L_binary(kernel, x, rows)
    if isinstance(kernel, OrthogonalCategorical):
        return compute_L_categorical(kernel, x, rows)
    if isinstance(kernel, OrthogonalRBF):
        m = kernel.measure
        if isinstance(m, EmpiricalMeasure):
            return compute_L_empirical(kernel, x, rows)
        if isinstance(m, GaussianMeasure):
            kw = dict(dtype=x.dtype, device=x.device)
            d = torch.sqrt(m.var) if delta is None else torch.as_tensor(delta, **kw)
            mean = m.mu if mu is None else torch.as_tensor(mu, **kw)
            l = kernel.lengthscale.value
            Lc = compute_L_gaussian(x, l, kernel.variance.value, d, mean, rows)
            if delta is None and mu is None:
                Lq = compute_L_quadrature(kernel, x, rows=rows)
            else:
                # the quadrature grid under the override measure too
                s, w = _gauss_hermite_grid(mean.reshape(1), (d * d).reshape(1),
                                           torch.ones(1, **kw), 64)
                G = ortho_rbf.K(kernel, x, s)
                Lq = (G[..., rows, :] * w) @ G.mT
            return torch.where((l > 0.5 * d)[..., None, None], Lq, Lc)
        if isinstance(m, (MOGMeasure, UniformMeasure)):
            return compute_L_quadrature(kernel, x, rows=rows)
    raise NotImplementedError(type(kernel))


# --------------------------------------------------------------------------- #
# Factor forms: L_d = F diag(w) Fᵀ
# --------------------------------------------------------------------------- #
def factor_form(kernel, x: torch.Tensor, num_points: int = 64
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(F [..., N, Q], w [..., Q]) with L = F diag(w) Fᵀ, or None for a
    kernel with no factor form (x [N], or [G, N] for a stacked group).
    alphaᵀ L alpha = Σ_q w_q (Fᵀ alpha)_q² sums non-negative terms, where
    the Hadamard route's O(N²) signed products cancel when alpha is large
    (near-noiseless fits)."""
    if isinstance(kernel, OrthogonalBinary):
        return (table_rows(ortho_binary.output_covariance(kernel), x),
                _binary_p(kernel))
    if isinstance(kernel, OrthogonalCategorical):
        return (table_rows(ortho_categorical.output_covariance(kernel), x),
                kernel.p[..., 0])
    if isinstance(kernel, OrthogonalRBF):
        m = kernel.measure
        kw = dict(dtype=x.dtype, device=x.device)
        if isinstance(m, EmpiricalMeasure):
            return ortho_rbf.K(kernel, x, m.location[..., 0]), m.weights[..., 0]
        if isinstance(m, GaussianMeasure):
            s, w = _gauss_hermite_grid(m.mu[..., None], m.var[..., None],
                                       torch.ones_like(m.mu)[..., None], num_points)
        elif isinstance(m, MOGMeasure):
            s, w = _gauss_hermite_grid(m.means, m.variances, m.weights, num_points)
        elif isinstance(m, UniformMeasure):
            q, w_ = np.polynomial.legendre.leggauss(num_points)
            s = (0.5 * (m.b - m.a)[..., None] * torch.as_tensor(q, **kw)
                 + 0.5 * (m.a + m.b)[..., None])
            w = (torch.as_tensor(w_, **kw) * 0.5).expand(s.shape)
        else:
            return None
        return ortho_rbf.K(kernel, x, s), w
    return None


# --------------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------------- #
def _into(out: torch.Tensor, idx: List[int], part: torch.Tensor) -> None:
    """out[idx] = part along the first axis (a slice copy when idx is a run)."""
    if idx == list(range(idx[0], idx[-1] + 1)):
        out[idx[0]:idx[-1] + 1].copy_(part)
    else:
        out.index_copy_(0, _index(idx, out.device), part)


def _dim_L_stack(oak: OAKKernel, X: torch.Tensor, delta=None, mu=None,
                 rows: slice = slice(None)) -> torch.Tensor:
    """[D, N, N] per-dim L matrices (their ``rows``: [D, n_rows, N]), built
    by group in chunks of ``kernels.per_group``'s size: the Gaussian L
    evaluates both of its branches, so a whole group at N = 8192 would hold
    several [G, N, N] buffers at once. The chunks are sized by the whole
    [N, N], so that every shard groups the same dims (and rounds alike)."""
    N = X.shape[0]
    n = len(range(N)[rows])
    out = None
    for idx, L in per_group(oak.kernels, X,
                            lambda k, x: compute_L_for_kernel(k, x, delta, mu, rows),
                            dim_elements=N * N):
        if len(idx) == oak.num_dims:
            return L
        if out is None:
            out = L.new_empty((oak.num_dims, n, N))
        _into(out, idx, L)
    return out


def _order_scales(oak: OAKKernel, orders: torch.Tensor, dtype) -> torch.Tensor:
    """Per-component scale: variances[order]² in shared mode, else 1."""
    if not oak.share_var_across_orders:
        return torch.ones(orders.shape, dtype=dtype, device=orders.device)
    vs = torch.stack([v.value.reshape(()) for v in oak.variances]).to(dtype)
    return (vs ** 2)[orders]


def _host_constrained(raw: np.ndarray, b) -> np.ndarray:
    """A Param's constrained value computed in numpy from its raw value read
    to the host: ``oak_tpu`` routes on these exact numbers."""
    if isinstance(b, Softplus):
        return np.logaddexp(0.0, raw) + b.low
    if isinstance(b, Sigmoid):
        return b.low + (b.high - b.low) / (1.0 + np.exp(-raw))
    if isinstance(b, Exp):
        return np.exp(raw)
    return raw


def _has_factor_form(kernel) -> bool:
    """Whether ``factor_form`` returns a pair for this kernel (the same type
    dispatch, without building anything)."""
    if isinstance(kernel, (OrthogonalBinary, OrthogonalCategorical)):
        return True
    if isinstance(kernel, OrthogonalRBF):
        return isinstance(kernel.measure, (GaussianMeasure, MOGMeasure,
                                           UniformMeasure, EmpiricalMeasure))
    return False


def _factor_routing(oak: OAKKernel) -> Tuple[bool, ...]:
    """Per dim, whether its factor form is usable: every kernel with one,
    except a Gaussian-measure RBF whose lengthscale is at most 0.5·√var
    (quadrature nodes too sparse). Kernels without a factor form route to
    the Hadamard path, which raises a clean NotImplementedError. The
    lengthscale raws and measure variances come to the host in one
    transfer (as float64, exact) and are compared in their own dtypes, as
    ``oak_tpu`` compares them."""
    routing = [_has_factor_form(k) for k in oak.kernels]
    gauss = [i for i, k in enumerate(oak.kernels)
             if isinstance(k, OrthogonalRBF) and isinstance(k.measure, GaussianMeasure)]
    if not gauss:
        return tuple(routing)
    kernels = [oak.kernels[i] for i in gauss]
    raws = [k.lengthscale.raw.detach().reshape(()) for k in kernels]
    vars_ = [k.measure.var.detach().reshape(()) for k in kernels]
    host = torch.stack([torch.stack(raws).double(),
                        torch.stack(vars_).double()]).cpu().numpy()
    for i, k, raw, var, raw_t, var_t in zip(gauss, kernels, host[0], host[1], raws, vars_):
        l = float(_host_constrained(raw.astype(_np_dtype(raw_t)), k.lengthscale.bij))
        routing[i] = l > 0.5 * float(np.sqrt(var.astype(_np_dtype(var_t))))
    return tuple(routing)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


# --------------------------------------------------------------------------- #
# Latents
# --------------------------------------------------------------------------- #
def _model_X(model) -> torch.Tensor:
    X = model.inducing_points
    return model.data[0] if X is None else X


def num_latents(model) -> int:
    """Latent functions (SVGP: columns of q_mu) or outputs (GPR, SGPR:
    columns of Y)."""
    q = getattr(model, "q_mu", None)
    if q is not None:
        return int(q.raw.shape[1])
    data = getattr(model, "data", None)
    return int(data[1].shape[1]) if data is not None else 1


def _sliced_param(p: Param, index) -> Param:
    return Param(p.raw.detach()[index].clone(), bij=p.bij, trainable=p.trainable,
                 prior=p.prior)


def select_latent(model: nn.Module, latent: int) -> nn.Module:
    """A single-latent model for latent ``latent`` of a multi-latent one:
    q_mu and q_sqrt (SVGP) or Y (GPR, SGPR) sliced to one column, the kernel,
    likelihood and inducing points shared. A new module; ``model`` is not
    changed. A single-latent model is returned as it is."""
    R = num_latents(model)
    if not 0 <= latent < R:
        raise ValueError(f"latent={latent} out of range for a model with "
                         f"{R} latent function(s)")
    if R == 1:
        return model
    r = slice(latent, latent + 1)
    if getattr(model, "q_mu", None) is not None:
        q_sqrt = _sliced_param(model.q_sqrt, (slice(None), r) if model.q_diag else r)
        return type(model)(model.kernel, model.likelihood, model.Z,
                           _sliced_param(model.q_mu, (slice(None), r)), q_sqrt,
                           q_diag=model.q_diag, whiten=model.whiten,
                           num_data=model.num_data)
    Y = model.Y[:, r].clone()
    if hasattr(model, "Z"):
        return type(model)(model.kernel, model.likelihood, model.Z, model.X, Y)
    return type(model)(model.kernel, model.likelihood, model.X, Y)


def resolve_latent(model: nn.Module, latent: Optional[int] = None) -> nn.Module:
    """The model restricted to one latent. ``latent=None`` requires a
    single-latent model (the reference silently takes latent 0)."""
    if latent is not None:
        return select_latent(model, int(latent))
    R = num_latents(model)
    if R > 1:
        raise NotImplementedError(
            f"model has {R} latent functions/outputs; Sobol decomposition "
            "and effect plots attribute the variance of ONE latent — pass "
            "latent=r (0..R-1) to the Sobol APIs, or use the single-latent "
            "view oak_tpu_torch.sobol.select_latent(model, r)")
    return model


def check_single_latent(model: nn.Module) -> None:
    """Raises on a multi-latent model (see ``resolve_latent``)."""
    resolve_latent(model, None)


# --------------------------------------------------------------------------- #
# Quadratic forms of every component
# --------------------------------------------------------------------------- #
# Cap on the bytes of one prefix matrix Q_k [C_k, N²] of the ladder. Live at
# once: the L stack, Lf, Q_k and the next Q, so peak ~2·cap + the stack.
# 16 GiB keeps that near 40 GB on an 80 GB H100 and covers depth 4 at D = 32,
# M = 512 (C_3 = 4,960 rows: 5.2 GB in f32, 10.4 GB in f64), so the f64 check
# on the card takes the f32 route. Above it the remaining orders take the
# chunked route. Tests lower it to force that route.
#
# Order 3 stays on the ladder on every device. oak_tpu computes it on
# accelerators as one contraction Σ_x Q_1[r, x] Lf[l, x] Lf[d, x]; on an
# NVIDIA H100 80GB HBM3 (700 W) at the bench SVGP (D = 32, M = 512) that took
# 2.65 ms against the ladder's 2.17 ms (host clock with sync, median of 5),
# for twice the FLOPs, so the port has no such route.
_LADDER_BYTES_CAP = 16 * 1024 ** 3


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _ladder_quadforms(Lstack: torch.Tensor, a: torch.Tensor, D: int,
                      max_order: int, rows: slice = slice(None)) -> Dict[int, torch.Tensor]:
    """alphaᵀ (⊙ of the L_d) alpha for every combination of every order
    1..max_order, batched: {order: values in itertools.combinations order}.

    Each L is flattened to a row of Lf [D, N²] and alpha folded in once,
    Q_1 = Lf ⊙ vec(a aᵀ); for each next order the values of every one-dim
    extension are one GEMM ext = Q_{k-1} Lfᵀ [C_{k-1}, D], and Q_k gathers
    the surviving (prefix, last) rows. Extending prefixes lexicographically
    keeps the combinations order.

    ``Lstack`` may hold only the ``rows`` of each L ([D, n_rows, N], a
    shard's block): the values are then this block's share of the sums.
    The routes are chosen on the whole N², so every shard takes the
    unsharded route."""
    N = Lstack.shape[2]
    X = N * N
    itemsize = Lstack.element_size()
    if D * X * itemsize > _LADDER_BYTES_CAP:
        # even Q_1 [D, N²] is over the cap (dense large-N GPR)
        return _chunked_quadforms(Lstack, a, D, 1, max_order, rows)
    Lf = Lstack[:D].reshape(D, -1)
    Q = Lf * (a[rows, None] * a[None, :]).reshape(-1)[None, :]  # [D, X]
    # N² signed terms, which cancel on near-noiseless fits: summed in float64
    vals = {1: torch.sum(Q, dim=1, dtype=torch.float64)}
    prefixes = [(d,) for d in range(D)]
    for k in range(2, max_order + 1):
        ext = Q @ Lf.T  # [C_{k-1}, D]
        heads, lasts, new_prefixes = [], [], []
        for r, t in enumerate(prefixes):
            for last in range(t[-1] + 1, D):
                heads.append(r)
                lasts.append(last)
                new_prefixes.append(t + (last,))
        heads_t, lasts_t = _index(heads, Lf.device), _index(lasts, Lf.device)
        vals[k] = ext[heads_t, lasts_t]
        if k == max_order:
            break
        if len(new_prefixes) * X * itemsize > _LADDER_BYTES_CAP:
            vals.update(_chunked_quadforms(Lstack, a, D, k + 1, max_order, rows))
            break
        Q = Q[heads_t] * Lf[lasts_t]
        prefixes = new_prefixes
    return vals


def _chunked_quadforms(Lstack: torch.Tensor, a: torch.Tensor, D: int,
                       order_from: int, order_to: int,
                       rows: slice = slice(None)) -> Dict[int, torch.Tensor]:
    """The memory-bounded route: Hadamard products of B components at a
    time, B chosen so that the [B, N, N] product stays at 2²⁷ elements
    (``Lstack`` may hold the ``rows`` of each L only, as in the ladder)."""
    N = Lstack.shape[2]
    B = max(1, min(256, int(2 ** 27 // max(N * N, 1))))
    out = {}
    for k in range(order_from, order_to + 1):
        idx = _index(list(itertools.combinations(range(D), k)),
                     Lstack.device).reshape(-1, k)
        parts = []
        for c0 in range(0, idx.shape[0], B):
            ci = idx[c0:c0 + B]
            L = Lstack[ci[:, 0]]
            for j in range(1, k):
                L = L * Lstack[ci[:, j]]
            parts.append(torch.einsum("n,bnm,m->b", a[rows], L, a))
        out[k] = torch.cat(parts) if parts else Lstack.new_zeros((0,))
    return out


def _factor_stack(oak: OAKKernel, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every dim's factor form, zero-padded to a common Q: (F [D, N, Q],
    w [D, Q]), built by group."""
    parts = list(per_group(oak.kernels, X, factor_form))
    if len(parts) == 1:
        return parts[0][1]
    Qmax = max(F.shape[-1] for _, (F, _w) in parts)
    Fs = X.new_zeros((oak.num_dims, X.shape[0], Qmax))
    Ws = X.new_zeros((oak.num_dims, Qmax))
    for idx, (F, w) in parts:
        Q = F.shape[-1]
        _into(Fs[..., :Q], idx, F)
        _into(Ws[..., :Q], idx, w)
    return Fs, Ws


def _factor_sums(Fs: torch.Tensor, a: torch.Tensor,
                 pairs: List[List[int]]) -> List[torch.Tensor]:
    """The contractions over N the factor forms' values are made of: Fᵀa
    [D, Q] and, for ``pairs``, F_iᵀ diag(a) F_j [C2, Q, Q] (all pairs in one
    batched contraction). Over a block of rows they are that block's share."""
    out = [torch.einsum("dnq,n->dq", Fs, a)]
    if pairs:
        pidx = _index(pairs, Fs.device)
        Fi = (Fs * a[None, :, None])[pidx[:, 0]]  # [C2, N, Q]
        out.append(torch.einsum("cnq,cnp->cqp", Fi, Fs[pidx[:, 1]]))
    return out


def _factor_quadforms(sums: List[torch.Tensor], Ws: torch.Tensor,
                      pairs: List[List[int]]) -> Dict[str, torch.Tensor]:
    """{"R1": the D order-1 values, "R2": the values of ``pairs``} from
    ``_factor_sums``: Σ_q w_q (Fᵀa)_q² and Σ_qp w_q w_p (F_iᵀ diag(a)
    F_j)_qp²."""
    V = sums[0]
    out = {"R1": torch.sum(Ws * V * V, dim=1)}
    if pairs:
        pidx = _index(pairs, Ws.device)
        T = sums[1]
        out["R2"] = torch.einsum("cq,cqp,cp->c", Ws[pidx[:, 0]], T * T, Ws[pidx[:, 1]])
    return out


def _reduced(axis, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``parts`` summed over the axis in one all-reduce (as they are
    without one)."""
    if axis is None or not parts:
        return parts
    from .parallel.mesh import _flat, _shapes, _unflat

    return _unflat(axis.all_reduce(_flat(parts)), _shapes(parts))


def _sobol_values(model, depth: int, routing: Sequence[bool], axis=None) -> torch.Tensor:
    """Every component's Sobol value (component order, the constant
    skipped). Orders 1-2 use the factor forms when every dim's is usable;
    the other orders, or all of them, the ladder over the L stack. With an
    ``axis`` (``parallel.mesh.Axis``) each rank works on its block of rows
    and the partial sums are all-reduced once."""
    oak: OAKKernel = model.kernel
    X = _model_X(model)
    a = model.posterior_alpha()[:, 0]
    rows = slice(None) if axis is None else axis.rows(X.shape[0])
    tuples = component_index_tuples(oak.num_dims, depth)[1:]
    all_factor = all(routing)

    sums: List[torch.Tensor] = []
    pairs: List[List[int]] = []
    if all_factor:
        Fs, Ws = _factor_stack(oak, X[rows])
        pairs = [t for t in tuples if len(t) == 2]
        sums = _factor_sums(Fs, a[rows], pairs)
        hadamard = [t for t in tuples if len(t) > 2]
    else:
        hadamard = tuples
    if hadamard:
        orders = sorted({len(t) for t in hadamard})
        ladder = _ladder_quadforms(_dim_L_stack(oak, X, rows=rows), a, oak.num_dims,
                                   orders[-1], rows)
        # hadamard holds, per order, every combination in combinations order
        sums.append(torch.cat([ladder[k] for k in orders]))
    sums = [s.to(a.dtype) for s in _reduced(axis, sums)]
    parts = {}
    if all_factor:
        parts = _factor_quadforms(sums, Ws, pairs)
    if hadamard:
        parts["RH"] = sums[-1]
    return _assemble(parts, tuples, all_factor, oak, X.device)


def _assemble(parts: Dict[str, torch.Tensor], tuples: List[List[int]],
              all_factor: bool, oak: OAKKernel, device) -> torch.Tensor:
    """One gather from [R1 | R2 | RH] into component order, times each
    component's order scale."""
    offsets, off = {}, 0
    for name in ("R1", "R2", "RH"):
        if name in parts:
            offsets[name] = off
            off += parts[name].shape[0]
    src = np.empty(len(tuples), np.int64)
    i2 = ih = 0
    for i, t in enumerate(tuples):
        if all_factor and len(t) == 1:
            src[i] = offsets["R1"] + t[0]
        elif all_factor and len(t) == 2:
            src[i] = offsets["R2"] + i2
            i2 += 1
        else:
            src[i] = offsets["RH"] + ih
            ih += 1
    values = torch.cat([parts[n] for n in offsets])[_index(src, device)]
    orders_t = _index([len(t) for t in tuples], device)
    return values * _order_scales(oak, orders_t, values.dtype)


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #
def _check_depth_override(oak: OAKKernel, depth: Optional[int]) -> int:
    """None and 0 mean the kernel's own depth; a depth above it would
    fabricate orders the model does not have; a negative one is an error."""
    if depth is None or depth == 0:
        return oak.max_interaction_depth
    if depth < 0:
        raise ValueError(f"max depth override must be >= 1 (got {depth}); "
                         "pass None or 0 for the kernel's own depth")
    if depth > oak.max_interaction_depth:
        raise ValueError(
            f"max depth override {depth} exceeds the kernel's "
            f"max_interaction_depth={oak.max_interaction_depth}; the model "
            "has no higher-order components to attribute variance to")
    return depth


def _check_measure_override(oak: OAKKernel, delta, mu) -> None:
    """The Sobol measure lives in each kernel; an override (delta a standard
    deviation) must match every Gaussian measure's, or this raises."""
    if delta is None and mu is None:
        return
    for k in oak.kernels:
        if isinstance(k, OrthogonalRBF) and isinstance(k.measure, GaussianMeasure):
            m_mu = float(k.measure.mu)
            m_sd = float(np.sqrt(float(k.measure.var)))
            if ((delta is not None and not np.isclose(float(delta), m_sd))
                    or (mu is not None and not np.isclose(float(mu), m_mu))):
                raise NotImplementedError(
                    f"Sobol measure override N({mu}, {delta}^2) differs from "
                    f"the kernel's own measure N({m_mu}, {m_sd}^2); rebuild "
                    "the kernel with the desired measure instead — kernels "
                    "carry their measure")


def _axis(mesh):
    from .parallel.mesh import first_axis

    return first_axis(mesh)


@torch.no_grad()
def compute_sobol_oak(model, delta=None, mu=None,
                      max_interaction_depth: Optional[int] = None,
                      latent: Optional[int] = None, mesh=None
                      ) -> Tuple[List[List[int]], np.ndarray]:
    """(tuples, values): the Sobol index of every additive component, the
    constant skipped, in the reference's component order, values as numpy.
    ``delta``/``mu`` must match the kernels' own measure; ``latent`` picks
    one latent of a multi-latent model (required there). ``mesh``: the
    O(N²) work sharded over the mesh's first axis (module docstring); every
    rank returns all the values."""
    oak: OAKKernel = model.kernel
    model = resolve_latent(model, latent)
    _check_measure_override(oak, delta, mu)
    depth = _check_depth_override(oak, max_interaction_depth)
    tuples = component_index_tuples(oak.num_dims, depth)[1:]
    values = _sobol_values(model, depth, _factor_routing(oak), _axis(mesh))
    return tuples, values.cpu().numpy()


@torch.no_grad()
def compute_sobol_by_order(model, delta=None, mu=None,
                           max_depth: Optional[int] = None,
                           latent: Optional[int] = None, mesh=None) -> np.ndarray:
    """Total unnormalised Sobol mass per order 1..P in O(D·P), by
    Newton–Girard over the L matrices, with no tuple enumeration. Shares the
    Hadamard form's conditioning: prefer sums of ``compute_sobol_oak`` on
    near-noiseless fits. ``mesh``: each rank takes a block of rows of the L
    matrices, and the per-order values are all-reduced."""
    model = resolve_latent(model, latent)
    oak: OAKKernel = model.kernel
    _check_measure_override(oak, delta, mu)
    depth = _check_depth_override(oak, max_depth)
    a = model.posterior_alpha()[:, 0]
    axis = _axis(mesh)
    N = a.shape[0]
    rows = slice(None) if axis is None else axis.rows(N)
    s = None
    # chunks sized by the whole [N, N], as in _dim_L_stack: every shard sums
    # the same dims into its power sums in the same order
    for _, L in per_group(oak.kernels, _model_X(model),
                          lambda k, x: compute_L_for_kernel(k, x, rows=rows),
                          dim_elements=N * N):
        s = power_sums_stacked(L, depth, s)
    e = newton_girard_from_power_sums(s, depth)[1:]
    orders = torch.arange(1, depth + 1, device=a.device)
    # the sum over rows cancels on near-noiseless fits: taken in float64
    partial = torch.stack([torch.dot((En @ a).double(), a[rows].double()) for En in e])
    (values,) = _reduced(axis, [partial])
    return (values.to(a.dtype) * _order_scales(oak, orders, a.dtype)).cpu().numpy()


@torch.no_grad()
def get_prediction_component(model, alpha=None, X: Optional[torch.Tensor] = None,
                             max_interaction_depth: Optional[int] = None,
                             latent: Optional[int] = None, mesh=None) -> np.ndarray:
    """Per-component predictive means [C, N] in component order; with the
    constant term σ²_0 Σ alpha they sum to the predictive mean. ``alpha``
    is accepted for the reference's API and recomputed from the model.
    ``mesh``: each rank computes a block of the rows of X, and the blocks
    are gathered."""
    oak: OAKKernel = model.kernel
    model = resolve_latent(model, latent)
    if X is None:
        X = model.data[0]
    depth = _check_depth_override(oak, max_interaction_depth)
    Xc = _model_X(model)
    X = torch.as_tensor(X, dtype=Xc.dtype, device=Xc.device)
    axis = _axis(mesh)
    n_rows = X.shape[0]
    if axis is not None:
        X = X[axis.rows(n_rows)]
    a = model.posterior_alpha()[:, 0]
    tuples = component_index_tuples(oak.num_dims, depth)[1:]

    D = oak.num_dims
    # [D + 1, S, Nc]: the per-dim grams by group; index D pads lower orders
    G = X.new_empty((D + 1, X.shape[0], Xc.shape[0]))
    for idx, grams in per_group(oak.kernels, X, kernel_K, Xc,
                                dim_elements=X.shape[0] * Xc.shape[0]):
        _into(G, idx, grams)
    G[D] = 1.0
    P = max(len(t) for t in tuples)
    idx = np.full((len(tuples), P), D, dtype=np.int64)
    for i, t in enumerate(tuples):
        idx[i, :len(t)] = t
    idx_t = _index(idx, X.device)
    orders = _index([len(t) for t in tuples], X.device)
    if oak.share_var_across_orders:
        vs = torch.stack([v.value.reshape(()) for v in oak.variances]).to(G.dtype)
        scales = vs[orders]
    else:
        scales = torch.ones(orders.shape, dtype=G.dtype, device=G.device)

    # B components at a time: the [B, S, Nc] product stays at 2²⁷ elements
    B = max(1, min(len(tuples), int(2 ** 27 // max(G.shape[1] * G.shape[2], 1))))
    out = []
    for c0 in range(0, len(tuples), B):
        ci = idx_t[c0:c0 + B]
        Kc = G[ci[:, 0]]
        for j in range(1, P):
            Kc = Kc * G[ci[:, j]]
        out.append(scales[c0:c0 + B, None] * (Kc @ a))
    out = torch.cat(out)
    if axis is not None:
        out = axis.gather_rows(out.T.contiguous(), n_rows).T
    return out.cpu().numpy()


def normalize_sobol(sobol: np.ndarray, likelihood_variance: Optional[float] = None
                    ) -> np.ndarray:
    """sobol / (Σ sobol + noise variance). A model in the all-noise optimum
    has a total of 0, where 0/0 would be NaN in every ranking: it gets zeros
    and a warning."""
    sobol = np.asarray(sobol)
    denom = np.sum(sobol) + (likelihood_variance or 0.0)
    if not np.isfinite(denom) or denom <= 0.0:
        warnings.warn("total Sobol variance is zero or non-finite (degenerate "
                      "all-noise fit?); returning zeros", RuntimeWarning)
        return np.zeros_like(sobol)
    return sobol / denom
