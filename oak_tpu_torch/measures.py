"""Input measures for the orthogonality constraint, as modules of buffers
(``oak_tpu.measures``). Weight normalisation is checked at construction."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .config import resolve


class Measure(nn.Module):
    """Base class; ``_fields`` lists the buffers in the JAX package's order."""

    _fields: tuple = ()

    def __init__(self, **buffers: torch.Tensor):
        super().__init__()
        for name in self._fields:
            self.register_buffer(name, buffers[name])


class UniformMeasure(Measure):
    """Uniform measure on [a, b]."""

    _fields = ("a", "b")

    @classmethod
    def create(cls, a: float, b: float, dtype: Optional[torch.dtype] = None,
               device=None) -> "UniformMeasure":
        dtype, device = resolve(dtype, device)
        return cls(a=torch.tensor(a, dtype=dtype, device=device),
                   b=torch.tensor(b, dtype=dtype, device=device))


class GaussianMeasure(Measure):
    """N(mu, var) measure."""

    _fields = ("mu", "var")

    @classmethod
    def create(cls, mu: float, var: float, dtype: Optional[torch.dtype] = None,
               device=None) -> "GaussianMeasure":
        dtype, device = resolve(dtype, device)
        return cls(mu=torch.tensor(mu, dtype=dtype, device=device),
                   var=torch.tensor(var, dtype=dtype, device=device))


def _check_sums_to_one(weights, what: str) -> None:
    total = float(np.asarray(weights, dtype=np.float64).sum())
    if not np.isclose(total, 1.0, atol=1e-6):
        raise ValueError(f"{what} weights sum to {total}, not 1")


class EmpiricalMeasure(Measure):
    """Weighted dirac measure on data locations; location, weights: [M, 1]."""

    _fields = ("location", "weights")

    @classmethod
    def create(cls, location, weights=None, dtype: Optional[torch.dtype] = None,
               device=None) -> "EmpiricalMeasure":
        dtype, device = resolve(dtype, device)
        location = torch.as_tensor(np.asarray(location), dtype=dtype,
                                   device=device).reshape(-1, 1)
        if weights is None:
            weights = torch.full((location.shape[0], 1), 1.0 / location.shape[0],
                                 dtype=dtype, device=device)
        else:
            _check_sums_to_one(weights, "Empirical measure")
            weights = torch.as_tensor(np.asarray(weights), dtype=dtype,
                                      device=device).reshape(-1, 1)
        return cls(location=location, weights=weights)


class MOGMeasure(Measure):
    """Mixture-of-Gaussians measure; means, variances, weights: [K]."""

    _fields = ("means", "variances", "weights")

    @classmethod
    def create(cls, means, variances, weights, dtype: Optional[torch.dtype] = None,
               device=None) -> "MOGMeasure":
        dtype, device = resolve(dtype, device)
        def vec(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=device).reshape(-1)

        means, variances, weights_t = vec(means), vec(variances), vec(weights)
        if not (means.shape == variances.shape == weights_t.shape):
            raise ValueError("means/variances/weights must share shape [K]")
        _check_sums_to_one(weights, "MOG")
        return cls(means=means, variances=variances, weights=weights_t)
