"""Constrained coregionalisation kernel on categorical inputs {0..C-1}
(``oak_tpu.kernels.ortho_categorical``).

A free PSD table A = W Wᵀ + diag(κ) is projected so that it is orthogonal to
constants under the categorical measure p: B = A - (Ap)(Ap)ᵀ / (pᵀAp). The
projection is formed on the factor, not entrywise (see ``_projected_factor``).
Inputs are [N], or [G, N] for a stacked group (``kernels.stack_group``): the
forms broadcast over the leading axes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import resolve
from ..params import Param, param, positive


class OrthogonalCategorical(nn.Module):
    _fields = ("W", "kappa", "variance", "p")

    def __init__(self, W: Param, kappa: Param, variance: Param, p: torch.Tensor,
                 active_dim: int = 0):
        super().__init__()
        self.W = W
        self.kappa = kappa
        self.variance = variance
        self.register_buffer("p", p)  # [C, 1] fixed measure probabilities
        self.active_dim = active_dim

    @classmethod
    def create(cls, p, rank: int = 2, variance=1.0, active_dim: int = 0,
               train_variance: bool = True,
               generator: Optional[torch.Generator] = None,
               dtype: Optional[torch.dtype] = None,
               device=None) -> "OrthogonalCategorical":
        dtype, device = resolve(dtype, device)
        p = torch.as_tensor(np.asarray(p), dtype=dtype, device=device).reshape(-1, 1)
        num_cat = p.shape[0]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # W ~ U[0, 1), drawn on the generator's (CPU) device and then moved
        W = torch.rand((num_cat, rank), generator=generator, dtype=dtype)
        return cls(param(W, dtype=dtype, device=device),
                   positive(torch.ones(num_cat, dtype=dtype), dtype=dtype,
                            device=device),
                   positive(variance, trainable=train_variance, dtype=dtype,
                            device=device),
                   p, active_dim)

    @property
    def num_cat(self) -> int:
        return self.p.shape[-2]


def _projected_factor(k: OrthogonalCategorical) -> torch.Tensor:
    """[..., C, rank+C] factor Ũ with B = Ũ Ũᵀ σ².

    With U = [W, diag(√κ)] and v = Uᵀp, B = U(I - vvᵀ/vᵀv)Uᵀ = ŨŨᵀ for
    Ũ = U - (Uv)vᵀ/(vᵀv): the subtraction happens in the factor, so f32 keeps
    B's digits where the entrywise form cancels ~3 of them. κ and vᵀv are
    floored at the smallest f32 normal, where sqrt's gradient stays finite."""
    W = k.W.value
    kap = k.kappa.value
    tiny = float(np.finfo(np.float32).tiny)
    U = torch.cat([W, torch.diag_embed(torch.sqrt(torch.clamp_min(kap, tiny)))], dim=-1)
    v = U.mT @ k.p  # [..., rank+C, 1]
    s = torch.clamp_min(torch.sum(v * v, dim=(-2, -1), keepdim=True), tiny)
    return U - (U @ v) @ v.mT / s


def output_covariance(k: OrthogonalCategorical) -> torch.Tensor:
    """[..., C, C] constrained table B."""
    Ut = _projected_factor(k)
    return (Ut @ Ut.mT) * k.variance.value[..., None, None]


def output_variance(k: OrthogonalCategorical) -> torch.Tensor:
    """diag(B), [..., C]."""
    Ut = _projected_factor(k)
    return torch.sum(Ut * Ut, dim=-1) * k.variance.value[..., None]


def table_rows(B: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B[x]: the rows [..., N, C] of tables B [..., C, C] at the levels x
    [..., N] (binary and categorical kernels)."""
    i = x.long()[..., :, None].expand(*x.shape, B.shape[-1])
    return torch.gather(B, -2, i)


def K(k: OrthogonalCategorical, x: torch.Tensor,
      x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x2 is None:
        x2 = x
    rows = table_rows(output_covariance(k), x)  # [..., N, C]
    j = x2.long()[..., None, :].expand(*x.shape, x2.shape[-1])
    return torch.gather(rows, -1, j)


def K_diag(k: OrthogonalCategorical, x: torch.Tensor) -> torch.Tensor:
    return torch.gather(output_variance(k), -1, x.long())
