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
the grams that give alpha. ``oak_tpu``'s ``mesh=`` arguments wait for the
multi-GPU item (ROADMAP P16).
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
                                 per_dim_batched)
from .kernels.ortho_binary import OrthogonalBinary
from .kernels.ortho_categorical import OrthogonalCategorical
from .kernels.ortho_rbf import OrthogonalRBF
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .ops.newton_girard import newton_girard
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


def compute_L_gaussian(x: torch.Tensor, lengthscale, variance, delta, mu) -> torch.Tensor:
    """[N, N] L of an OrthogonalRBF dim under N(mu, delta²), by
    broadcasting; the scalars may be tensors or floats."""
    l, variance, delta, mu = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                              for v in (lengthscale, variance, delta, mu))
    sigma = torch.sqrt(variance)
    xi, yj = x[:, None], x[None, :]
    return (f1(xi, yj, sigma, l, delta, mu) - f2(xi, yj, sigma, l, delta, mu)
            - f3(xi, yj, sigma, l, delta, mu) + f4(xi, yj, sigma, l, delta, mu))


# --------------------------------------------------------------------------- #
# Quadrature / matmul L matrices
# --------------------------------------------------------------------------- #
def compute_L_empirical(kernel: OrthogonalRBF, x: torch.Tensor) -> torch.Tensor:
    """L = Kxuᵀ diag(w) Kxu over the empirical locations."""
    m: EmpiricalMeasure = kernel.measure
    kxu = ortho_rbf.K(kernel, m.location[:, 0], x)  # [E, N]
    return (m.weights[:, 0][:, None] * kxu).T @ kxu


def _binary_p(kernel: OrthogonalBinary) -> torch.Tensor:
    return torch.stack([kernel.p0, 1.0 - kernel.p0])


def compute_L_binary(kernel: OrthogonalBinary, x: torch.Tensor) -> torch.Tensor:
    """L = B_x diag(p) B_xᵀ with the full-variance table B (PARITY_NOTES:
    the reference scales binary components by σ² instead of σ⁴)."""
    Bx = ortho_binary.output_covariance(kernel)[x.long()]  # [N, 2]
    return (Bx * _binary_p(kernel)[None, :]) @ Bx.T


def compute_L_categorical(kernel: OrthogonalCategorical, x: torch.Tensor) -> torch.Tensor:
    """L = B_x diag(p) B_xᵀ with B_x the gathered rows of the table."""
    Bx = ortho_categorical.output_covariance(kernel)[x.long()]  # [N, C]
    return (Bx * kernel.p[:, 0][None, :]) @ Bx.T


def _gauss_hermite_grid(means: torch.Tensor, variances: torch.Tensor,
                        weights: torch.Tensor, num_points: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodes and weights [K·Q] of Q-point Gauss–Hermite under each of K
    Gaussian components, in the dtype and on the device of ``means``."""
    q, w = np.polynomial.hermite_e.hermegauss(num_points)
    kw = dict(dtype=means.dtype, device=means.device)
    q = torch.as_tensor(q, **kw)
    w = torch.as_tensor(w / np.sqrt(2.0 * np.pi), **kw)
    s = means[:, None] + torch.sqrt(variances)[:, None] * q[None, :]  # [K, Q]
    return s.reshape(-1), (weights[:, None] * w[None, :]).reshape(-1)


def compute_L_quadrature(kernel: OrthogonalRBF, x: torch.Tensor,
                         num_points: int = 64) -> torch.Tensor:
    """L = G diag(w) Gᵀ with G = K(x, grid), for any measure with a factor
    form (MOG and uniform, and Gaussian as a check on the closed form)."""
    fw = factor_form(kernel, x, num_points)
    if fw is None:
        raise NotImplementedError(type(kernel.measure))
    G, w = fw
    return (G * w[None, :]) @ G.T


def compute_L_for_kernel(kernel, x: torch.Tensor, delta=None, mu=None) -> torch.Tensor:
    """The L of one constituent kernel on its sliced column ``x``.

    A Gaussian measure takes the closed form for l <= 0.5·δ and 64-point
    Gauss–Hermite quadrature above: the closed form's four terms are each
    ~σ⁴ and cancel once l exceeds the measure's scale, while quadrature is
    exact there and only fails for l far below the node spacing. Both are
    evaluated and one selected with ``torch.where``; the unused closed form
    may hold inf or NaN at large l, which the selection drops (no gradient
    flows through Sobol). ``delta`` (a standard deviation) and ``mu``
    override the kernel's own measure."""
    if isinstance(kernel, OrthogonalBinary):
        return compute_L_binary(kernel, x)
    if isinstance(kernel, OrthogonalCategorical):
        return compute_L_categorical(kernel, x)
    if isinstance(kernel, OrthogonalRBF):
        m = kernel.measure
        if isinstance(m, EmpiricalMeasure):
            return compute_L_empirical(kernel, x)
        if isinstance(m, GaussianMeasure):
            kw = dict(dtype=x.dtype, device=x.device)
            d = torch.sqrt(m.var) if delta is None else torch.as_tensor(delta, **kw)
            mean = m.mu if mu is None else torch.as_tensor(mu, **kw)
            l = kernel.lengthscale.value
            Lc = compute_L_gaussian(x, l, kernel.variance.value, d, mean)
            if delta is None and mu is None:
                Lq = compute_L_quadrature(kernel, x)
            else:
                # the quadrature grid under the override measure too
                s, w = _gauss_hermite_grid(mean.reshape(1), (d * d).reshape(1),
                                           torch.ones(1, **kw), 64)
                G = ortho_rbf.K(kernel, x, s)
                Lq = (G * w[None, :]) @ G.T
            return torch.where(l > 0.5 * d, Lq, Lc)
        if isinstance(m, (MOGMeasure, UniformMeasure)):
            return compute_L_quadrature(kernel, x)
    raise NotImplementedError(type(kernel))


# --------------------------------------------------------------------------- #
# Factor forms: L_d = F diag(w) Fᵀ
# --------------------------------------------------------------------------- #
def factor_form(kernel, x: torch.Tensor, num_points: int = 64
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(F [N, Q], w [Q]) with L = F diag(w) Fᵀ, or None for a kernel with
    no factor form. alphaᵀ L alpha = Σ_q w_q (Fᵀ alpha)_q² sums non-negative
    terms, where the Hadamard route's O(N²) signed products cancel when
    alpha is large (near-noiseless fits)."""
    if isinstance(kernel, OrthogonalBinary):
        return ortho_binary.output_covariance(kernel)[x.long()], _binary_p(kernel)
    if isinstance(kernel, OrthogonalCategorical):
        return (ortho_categorical.output_covariance(kernel)[x.long()],
                kernel.p[:, 0])
    if isinstance(kernel, OrthogonalRBF):
        m = kernel.measure
        kw = dict(dtype=x.dtype, device=x.device)
        if isinstance(m, EmpiricalMeasure):
            return ortho_rbf.K(kernel, x, m.location[:, 0]), m.weights[:, 0]
        if isinstance(m, GaussianMeasure):
            s, w = _gauss_hermite_grid(m.mu.reshape(1), m.var.reshape(1),
                                       torch.ones(1, **kw), num_points)
        elif isinstance(m, MOGMeasure):
            s, w = _gauss_hermite_grid(m.means, m.variances, m.weights, num_points)
        elif isinstance(m, UniformMeasure):
            q, w_ = np.polynomial.legendre.leggauss(num_points)
            s = 0.5 * (m.b - m.a) * torch.as_tensor(q, **kw) + 0.5 * (m.a + m.b)
            w = torch.as_tensor(w_, **kw) * 0.5
        else:
            return None
        return ortho_rbf.K(kernel, x, s), w
    return None


# --------------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------------- #
def _dim_L_stack(oak: OAKKernel, X: torch.Tensor, delta=None, mu=None) -> torch.Tensor:
    """[D, N, N] per-dim L matrices."""
    return torch.stack(per_dim_batched(
        oak.kernels, X, lambda k, x: compute_L_for_kernel(k, x, delta, mu)))


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
    gauss = [(i, k) for i, k in enumerate(oak.kernels)
             if isinstance(k, OrthogonalRBF) and isinstance(k.measure, GaussianMeasure)]
    if not gauss:
        return tuple(routing)
    pairs = [(k.lengthscale.raw.detach(), k.measure.var.detach()) for _, k in gauss]
    host = torch.stack([torch.stack([raw.reshape(()).double(), var.reshape(()).double()])
                        for raw, var in pairs]).cpu().numpy()
    for (i, k), (raw, var), (raw_t, var_t) in zip(gauss, host, pairs):
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
                      max_order: int) -> Dict[int, torch.Tensor]:
    """alphaᵀ (⊙ of the L_d) alpha for every combination of every order
    1..max_order, batched: {order: values in itertools.combinations order}.

    Each L is flattened to a row of Lf [D, N²] and alpha folded in once,
    Q_1 = Lf ⊙ vec(a aᵀ); for each next order the values of every one-dim
    extension are one GEMM ext = Q_{k-1} Lfᵀ [C_{k-1}, D], and Q_k gathers
    the surviving (prefix, last) rows. Extending prefixes lexicographically
    keeps the combinations order."""
    N = Lstack.shape[1]
    X = N * N
    itemsize = Lstack.element_size()
    if D * X * itemsize > _LADDER_BYTES_CAP:
        # even Q_1 [D, N²] is over the cap (dense large-N GPR)
        return _chunked_quadforms(Lstack, a, D, 1, max_order)
    Lf = Lstack[:D].reshape(D, X)
    Q = Lf * (a[:, None] * a[None, :]).reshape(X)[None, :]  # [D, X]
    vals = {1: torch.sum(Q, dim=1)}
    prefixes = [(d,) for d in range(D)]
    for k in range(2, max_order + 1):
        ext = Q @ Lf.T  # [C_{k-1}, D]
        rows, lasts, new_prefixes = [], [], []
        for r, t in enumerate(prefixes):
            for last in range(t[-1] + 1, D):
                rows.append(r)
                lasts.append(last)
                new_prefixes.append(t + (last,))
        rows_t, lasts_t = _index(rows, Lf.device), _index(lasts, Lf.device)
        vals[k] = ext[rows_t, lasts_t]
        if k == max_order:
            break
        if len(new_prefixes) * X * itemsize > _LADDER_BYTES_CAP:
            vals.update(_chunked_quadforms(Lstack, a, D, k + 1, max_order))
            break
        Q = Q[rows_t] * Lf[lasts_t]
        prefixes = new_prefixes
    return vals


def _chunked_quadforms(Lstack: torch.Tensor, a: torch.Tensor, D: int,
                       order_from: int, order_to: int) -> Dict[int, torch.Tensor]:
    """The memory-bounded route: Hadamard products of B components at a
    time, B chosen so that the [B, N, N] product stays at 2²⁷ elements."""
    N = Lstack.shape[1]
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
            parts.append(torch.einsum("n,bnm,m->b", a, L, a))
        out[k] = torch.cat(parts) if parts else Lstack.new_zeros((0,))
    return out


def _factor_stack(oak: OAKKernel, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every dim's factor form, zero-padded to a common Q: (F [D, N, Q],
    w [D, Q])."""
    factors = per_dim_batched(oak.kernels, X, factor_form)
    Qmax = max(F.shape[1] for F, _ in factors)
    pad = torch.nn.functional.pad
    return (torch.stack([pad(F, (0, Qmax - F.shape[1])) for F, _ in factors]),
            torch.stack([pad(w, (0, Qmax - w.shape[0])) for _, w in factors]))


def _factor_quadforms(Fs: torch.Tensor, Ws: torch.Tensor, a: torch.Tensor,
                      pairs: List[List[int]]) -> Dict[str, torch.Tensor]:
    """{"R1": the D order-1 values, "R2": the values of ``pairs``} from the
    factor forms: Σ_q w_q (Fᵀa)_q² and Σ_qp w_q w_p (F_iᵀ diag(a) F_j)_qp²,
    all pairs in one batched contraction."""
    V = torch.einsum("dnq,n->dq", Fs, a)
    out = {"R1": torch.sum(Ws * V * V, dim=1)}
    if pairs:
        pidx = _index(pairs, Fs.device)
        Fi = (Fs * a[None, :, None])[pidx[:, 0]]  # [C2, N, Q]
        T = torch.einsum("cnq,cnp->cqp", Fi, Fs[pidx[:, 1]])
        out["R2"] = torch.einsum("cq,cqp,cp->c", Ws[pidx[:, 0]], T * T, Ws[pidx[:, 1]])
    return out


def _sobol_values(model, depth: int, routing: Sequence[bool]) -> torch.Tensor:
    """Every component's Sobol value (component order, the constant
    skipped). Orders 1-2 use the factor forms when every dim's is usable;
    the other orders, or all of them, the ladder over the L stack."""
    oak: OAKKernel = model.kernel
    X = _model_X(model)
    a = model.posterior_alpha()[:, 0]
    tuples = component_index_tuples(oak.num_dims, depth)[1:]
    all_factor = all(routing)

    parts = {}
    if all_factor:
        Fs, Ws = _factor_stack(oak, X)
        parts = _factor_quadforms(Fs, Ws, a, [t for t in tuples if len(t) == 2])
        hadamard = [t for t in tuples if len(t) > 2]
    else:
        hadamard = tuples
    if hadamard:
        orders = sorted({len(t) for t in hadamard})
        ladder = _ladder_quadforms(_dim_L_stack(oak, X), a, oak.num_dims, orders[-1])
        # hadamard holds, per order, every combination in combinations order
        parts["RH"] = torch.cat([ladder[k] for k in orders])
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


@torch.no_grad()
def compute_sobol_oak(model, delta=None, mu=None,
                      max_interaction_depth: Optional[int] = None,
                      latent: Optional[int] = None
                      ) -> Tuple[List[List[int]], np.ndarray]:
    """(tuples, values): the Sobol index of every additive component, the
    constant skipped, in the reference's component order, values as numpy.
    ``delta``/``mu`` must match the kernels' own measure; ``latent`` picks
    one latent of a multi-latent model (required there)."""
    oak: OAKKernel = model.kernel
    model = resolve_latent(model, latent)
    _check_measure_override(oak, delta, mu)
    depth = _check_depth_override(oak, max_interaction_depth)
    tuples = component_index_tuples(oak.num_dims, depth)[1:]
    values = _sobol_values(model, depth, _factor_routing(oak))
    return tuples, values.cpu().numpy()


@torch.no_grad()
def compute_sobol_by_order(model, delta=None, mu=None,
                           max_depth: Optional[int] = None,
                           latent: Optional[int] = None) -> np.ndarray:
    """Total unnormalised Sobol mass per order 1..P in O(D·P), by
    Newton–Girard over the L matrices, with no tuple enumeration. Shares the
    Hadamard form's conditioning: prefer sums of ``compute_sobol_oak`` on
    near-noiseless fits."""
    model = resolve_latent(model, latent)
    oak: OAKKernel = model.kernel
    _check_measure_override(oak, delta, mu)
    depth = _check_depth_override(oak, max_depth)
    a = model.posterior_alpha()[:, 0]
    mats = per_dim_batched(oak.kernels, _model_X(model), compute_L_for_kernel)
    e = newton_girard(mats, depth)[1:]
    orders = torch.arange(1, depth + 1, device=a.device)
    values = torch.stack([a @ En @ a for En in e]) * _order_scales(oak, orders, a.dtype)
    return values.cpu().numpy()


@torch.no_grad()
def get_prediction_component(model, alpha=None, X: Optional[torch.Tensor] = None,
                             max_interaction_depth: Optional[int] = None,
                             latent: Optional[int] = None) -> np.ndarray:
    """Per-component predictive means [C, N] in component order; with the
    constant term σ²_0 Σ alpha they sum to the predictive mean. ``alpha``
    is accepted for the reference's API and recomputed from the model."""
    oak: OAKKernel = model.kernel
    model = resolve_latent(model, latent)
    if X is None:
        X = model.data[0]
    depth = _check_depth_override(oak, max_interaction_depth)
    Xc = _model_X(model)
    X = torch.as_tensor(X, dtype=Xc.dtype, device=Xc.device)
    a = model.posterior_alpha()[:, 0]
    tuples = component_index_tuples(oak.num_dims, depth)[1:]

    grams = [kernel_K(k, X[:, k.active_dim], Xc[:, k.active_dim]) for k in oak.kernels]
    grams.append(torch.ones_like(grams[0]))  # index D pads lower orders
    G = torch.stack(grams)  # [D + 1, S, Nc]

    D = oak.num_dims
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
    return torch.cat(out).cpu().numpy()


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
