"""Constrained (orthogonal) RBF kernel on one input dimension
(``oak_tpu.kernels.ortho_rbf``).

    K(x, x') = k(x, x') - cov(x, s) cov(x', s) / var_s

with cov(x, s) = ∫ k(x, s) dμ(s) and var_s = ∬ k(s, s') dμ(s) dμ(s') in
closed form for the Gaussian, uniform, empirical and MOG measures. Inputs are
columns [N] of one kernel's active dim, or [G, N] for a stacked group
(``kernels.stack_group``, whose fields carry a leading group axis): every
form broadcasts over the leading axes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..measures import (EmpiricalMeasure, GaussianMeasure, Measure, MOGMeasure,
                        UniformMeasure)
from ..config import like
from ..params import Param, bounded, positive


class OrthogonalRBF(nn.Module):
    """One constrained 1-D RBF kernel; ``variance`` is the base variance σ²."""

    _fields = ("lengthscale", "variance", "measure")

    def __init__(self, lengthscale: Param, variance: Param, measure: Measure,
                 active_dim: int = 0):
        super().__init__()
        self.lengthscale = lengthscale
        self.variance = variance
        self.measure = measure
        self.active_dim = active_dim

    @classmethod
    def create(cls, measure: Measure, lengthscale=1.0, variance=1.0,
               active_dim: int = 0, lengthscale_bounds=None,
               train_variance: bool = True, dtype: Optional[torch.dtype] = None,
               device=None) -> "OrthogonalRBF":
        """Built in ``measure``'s dtype and device unless told otherwise."""
        dtype, device = like(measure, dtype, device)
        if lengthscale_bounds is not None:
            ls = bounded(lengthscale_bounds[0], lengthscale_bounds[1], lengthscale,
                         dtype=dtype, device=device)
        else:
            ls = positive(lengthscale, dtype=dtype, device=device)
        var = positive(variance, trainable=train_variance, dtype=dtype,
                       device=device)
        return cls(ls, var, measure, active_dim)


def _s(v: torch.Tensor) -> torch.Tensor:
    """A field that is a scalar per kernel (shape () for one kernel, [G] for
    a stacked group) broadcast over the last axis of inputs [..., N]."""
    return v[..., None]


def rbf(k, x: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unconstrained SE base gram, [..., N, M] from inputs [..., N], [..., M]."""
    if x2 is None:
        x2 = x
    d = (x[..., :, None] - x2[..., None, :]) / _s(_s(k.lengthscale.value))
    return _s(_s(k.variance.value)) * torch.exp(-0.5 * d * d)


def rbf_diag(k, x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x) * _s(k.variance.value)


def cov_x_s(k: OrthogonalRBF, x: torch.Tensor) -> torch.Tensor:
    """cov(x, s) = ∫ k(x, s) dμ(s), shape [..., N] for input [..., N]."""
    l = k.lengthscale.value
    s2 = k.variance.value
    m = k.measure
    if isinstance(m, GaussianMeasure):
        t = _s(l * l + m.var)
        return _s(s2 * l) / torch.sqrt(t) * torch.exp(-0.5 * (x - _s(m.mu)) ** 2 / t)
    if isinstance(m, UniformMeasure):
        c = _s(s2 * l / (m.b - m.a) * math.sqrt(math.pi / 2.0))
        r2l = _s(math.sqrt(2.0) * l)
        return c * (torch.erf((_s(m.b) - x) / r2l) - torch.erf((_s(m.a) - x) / r2l))
    if isinstance(m, EmpiricalMeasure):
        return (rbf(k, x, m.location[..., 0]) @ m.weights)[..., 0]
    if isinstance(m, MOGMeasure):
        t = _s(_s(l * l)) + m.variances[..., None, :]  # [..., 1, K]
        comp = torch.exp(-0.5 * (x[..., :, None] - m.means[..., None, :]) ** 2 / t) \
            / torch.sqrt(t)  # [..., N, K]
        return _s(s2 * l) * (comp @ m.weights[..., :, None])[..., 0]
    raise NotImplementedError(f"measure {type(m)}")


def var_s(k: OrthogonalRBF) -> torch.Tensor:
    """var_s = ∬ k(s, s') dμ(s) dμ(s'), one per kernel (shape () or [G])."""
    l = k.lengthscale.value
    s2 = k.variance.value
    m = k.measure
    if isinstance(m, GaussianMeasure):
        return s2 * l / torch.sqrt(l * l + 2.0 * m.var)
    if isinstance(m, UniformMeasure):
        y = (m.b - m.a) / (math.sqrt(2.0) * l)
        return (2.0 / (m.b - m.a) ** 2) * s2 * l * l * (
            math.sqrt(math.pi) * y * torch.erf(y) + torch.exp(-y * y) - 1.0)
    if isinstance(m, EmpiricalMeasure):
        loc = m.location[..., 0]
        return (m.weights.mT @ rbf(k, loc, loc) @ m.weights)[..., 0, 0]
    if isinstance(m, MOGMeasure):
        v, mu = m.variances, m.means
        t = _s(_s(l * l)) + v[..., :, None] + v[..., None, :]
        pair = torch.exp(-0.5 * (mu[..., :, None] - mu[..., None, :]) ** 2 / t) \
            / torch.sqrt(t)
        w = m.weights
        return s2 * l * (w[..., None, :] @ pair @ w[..., :, None])[..., 0, 0]
    raise NotImplementedError(f"measure {type(m)}")


def _var_s_floored(k: OrthogonalRBF) -> torch.Tensor:
    """var_s floored at sqrt(tiny), not tiny: with a pruned base variance
    var_s underflows to 0 and the downdate would be 0/0; the gradients of the
    division form var_s² and var_s^-3/2, which stay representable at
    sqrt(tiny) (1.1e-19 in f32)."""
    v = var_s(k)
    return torch.clamp_min(v, math.sqrt(torch.finfo(v.dtype).tiny))


def K(k: OrthogonalRBF, x: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Constrained gram: base minus the rank-1 downdate."""
    cx = cov_x_s(k, x)
    cx2 = cx if x2 is None else cov_x_s(k, x2)
    return (rbf(k, x, x2) - (cx[..., :, None] * cx2[..., None, :])
            / _s(_s(_var_s_floored(k))))


def K_diag(k: OrthogonalRBF, x: torch.Tensor) -> torch.Tensor:
    cx = cov_x_s(k, x)
    return rbf_diag(k, x) - cx * cx / _s(_var_s_floored(k))
