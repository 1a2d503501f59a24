"""Constrained kernel on binary inputs {0, 1} (``oak_tpu.kernels.ortho_binary``).

The 2x2 table B = σ² [[p1², -p0 p1], [-p0 p1, p0²]] is rank 1,
B = σ² φ φᵀ with φ(0) = p1 and φ(1) = -p0, so the gram is an outer product
evaluated from the float inputs, with no gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import resolve
from ..params import Param, positive


class OrthogonalBinary(nn.Module):
    _fields = ("variance", "p0")

    def __init__(self, variance: Param, p0: torch.Tensor, active_dim: int = 0):
        super().__init__()
        self.variance = variance
        self.register_buffer("p0", p0)
        self.active_dim = active_dim

    @classmethod
    def create(cls, p0: float = 0.5, variance=1.0, active_dim: int = 0,
               train_variance: bool = True, dtype: Optional[torch.dtype] = None,
               device=None) -> "OrthogonalBinary":
        dtype, device = resolve(dtype, device)
        return cls(positive(variance, trainable=train_variance, dtype=dtype,
                            device=device),
                   torch.tensor(p0, dtype=dtype, device=device), active_dim)


def output_covariance(k: OrthogonalBinary) -> torch.Tensor:
    """The 2x2 table B = σ² φ φᵀ, φ = (p1, -p0)."""
    phi = torch.stack([1.0 - k.p0, -k.p0])
    return k.variance.value * torch.outer(phi, phi)


def _phi(k: OrthogonalBinary, x: torch.Tensor) -> torch.Tensor:
    """x = 0 -> p1; x = 1 -> -p0."""
    return (1.0 - k.p0) - x


def K(k: OrthogonalBinary, x: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x2 is None:
        x2 = x
    return k.variance.value * torch.outer(_phi(k, x), _phi(k, x2))


def K_diag(k: OrthogonalBinary, x: torch.Tensor) -> torch.Tensor:
    p = _phi(k, x)
    return k.variance.value * p * p
