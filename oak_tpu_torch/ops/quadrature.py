"""Gauss–Hermite quadrature over 1-D Gaussians (``oak_tpu.ops.quadrature``),
for the Bernoulli likelihood's variational expectations and predictions.
Each call is the span ``oak.quad`` (``utils.profiling``)."""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.profiling import spanned

DEFAULT_NUM_POINTS = 20  # GPflow's default


@lru_cache(maxsize=None)
def _gh_points(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Nodes and weights for E_{x ~ N(0, 1)}: probabilists' Hermite."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / np.sqrt(2.0 * np.pi)


def _safe_scale(var: torch.Tensor) -> torch.Tensor:
    """sqrt of the variance with a strictly positive floor (1e-10 at f32,
    1e-30 at f64; PARITY_NOTES 6c). At a floor of 0, f32 cancellation in the
    predictive variance (var <= 0 where X meets an inducing point) gives a
    finite forward but sqrt'(0) = inf backward into every parameter that
    feeds var; with a positive floor the clamped point's gradient is 0."""
    floor = 1e-10 if var.dtype == torch.float32 else 1e-30
    return torch.sqrt(torch.clamp_min(var, floor))


def _grid(mean: torch.Tensor, var: torch.Tensor, num_points: int):
    x, w = _gh_points(num_points)
    x = torch.as_tensor(x, dtype=mean.dtype, device=mean.device)
    w = torch.as_tensor(w, dtype=mean.dtype, device=mean.device)
    return mean[..., None] + _safe_scale(var)[..., None] * x, w


@spanned("oak.quad")
def gauss_hermite(fn: Callable, mean: torch.Tensor, var: torch.Tensor,
                  num_points: int = DEFAULT_NUM_POINTS) -> torch.Tensor:
    """E_{x ~ N(mean, var)}[fn(x)], elementwise over mean and var."""
    grid, w = _grid(mean, var, num_points)
    return torch.sum(fn(grid) * w, dim=-1)


@spanned("oak.quad")
def log_gauss_hermite(log_fn: Callable, mean: torch.Tensor, var: torch.Tensor,
                      num_points: int = DEFAULT_NUM_POINTS) -> torch.Tensor:
    """log E[exp(log_fn(x))], through a logsumexp."""
    grid, w = _grid(mean, var, num_points)
    return torch.logsumexp(log_fn(grid) + torch.log(w), dim=-1)
