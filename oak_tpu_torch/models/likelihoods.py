"""Gaussian likelihood (``oak_tpu.models.likelihoods.Gaussian``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..params import Param, positive

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian(nn.Module):
    _fields = ("variance",)

    def __init__(self, variance: Param):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 1.0, dtype: torch.dtype = torch.float64,
               device=None) -> "Gaussian":
        # GPflow lower-bounds the likelihood variance at 1e-6
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
