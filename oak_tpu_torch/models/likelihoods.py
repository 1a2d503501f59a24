"""Likelihoods (``oak_tpu.models.likelihoods``): Gaussian in closed form,
Bernoulli by Gauss–Hermite quadrature."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..config import resolve
from ..ops.quadrature import gauss_hermite, log_gauss_hermite
from ..params import Param, positive

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian(nn.Module):
    _fields = ("variance",)

    def __init__(self, variance: Param):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 1.0, dtype: Optional[torch.dtype] = None,
               device=None) -> "Gaussian":
        # GPflow lower-bounds the likelihood variance at 1e-6
        dtype, device = resolve(dtype, device)
        return cls(positive(variance, low=1e-6, dtype=dtype, device=device))

    def log_prob(self, f, y):
        v = self.variance.value
        return -0.5 * (_LOG2PI + torch.log(v) + (y - f) ** 2 / v)

    def variational_expectations(self, fmu, fvar, y):
        """E_{f ~ N(fmu, fvar)}[log p(y | f)], in closed form."""
        v = self.variance.value
        return -0.5 * (_LOG2PI + torch.log(v) + ((y - fmu) ** 2 + fvar) / v)

    def predict_mean_and_var(self, fmu, fvar):
        # f32 cancellation in the sparse predictive variance can leave fvar
        # slightly negative at near-interpolated points; a prediction cannot
        # be more certain than exact interpolation, so clamp at 0 before the
        # noise is added
        return fmu, torch.clamp_min(fvar, 0.0) + self.variance.value

    def predict_log_density(self, fmu, fvar, y):
        v = torch.clamp_min(fvar, 0.0) + self.variance.value
        return -0.5 * (_LOG2PI + torch.log(v) + (y - fmu) ** 2 / v)


def inv_probit(x: torch.Tensor, jitter: float = 1e-3) -> torch.Tensor:
    """GPflow's default Bernoulli inverse link, squeezed into
    [jitter, 1 - jitter]."""
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0))) * (1.0 - 2.0 * jitter) + jitter


def inv_logit(x: torch.Tensor, jitter: float = 1e-3) -> torch.Tensor:
    """The jittered sigmoid link of the reference's classification script,
    on ``torch.sigmoid``, which is stable on both sides (PARITY_NOTES 6b):
    the naive 1 / (1 + exp(-x)) overflows f32 below x ≈ -88, and its
    backward is then inf / inf = NaN, which a deep kernel's wide quadrature
    grid reaches at a cold start."""
    return torch.sigmoid(x) * (1.0 - 2.0 * jitter) + jitter


_INVLINKS = {"probit": inv_probit, "logit": inv_logit}


class Bernoulli(nn.Module):
    """P(y = 1 | f) = invlink(f), y in {0, 1}; expectations by
    Gauss–Hermite quadrature with ``num_gh`` points. No parameters."""

    _fields = ()

    def __init__(self, invlink: str = "logit", num_gh: int = 20):
        super().__init__()
        if invlink not in _INVLINKS:
            raise ValueError(f"invlink must be one of {list(_INVLINKS)}")
        self.invlink_name = invlink
        self.num_gh = num_gh

    @classmethod
    def create(cls, invlink: str = "logit", num_gh: int = 20) -> "Bernoulli":
        return cls(invlink, num_gh)

    @property
    def invlink(self) -> Callable:
        return _INVLINKS[self.invlink_name]

    def log_prob(self, f, y):
        p = self.invlink(f)
        return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)

    def variational_expectations(self, fmu, fvar, y):
        return gauss_hermite(lambda f: self.log_prob(f, y[..., None]), fmu, fvar,
                             self.num_gh)

    def predict_mean_and_var(self, fmu, fvar):
        p = gauss_hermite(self.invlink, fmu, fvar, self.num_gh)
        return p, p - p * p

    def predict_log_density(self, fmu, fvar, y):
        return log_gauss_hermite(lambda f: self.log_prob(f, y[..., None]), fmu,
                                 fvar, self.num_gh)
