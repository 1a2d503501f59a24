"""PSD linear algebra: jittered Cholesky and triangular solves
(``oak_tpu.ops.psd``, the part the predict path uses).

The TPU package's blocked Cholesky and triangular inverse, its custom VJPs
and its refined solves were written around XLA:TPU's serial, bf16-internal
solvers; here ``torch.linalg`` runs in full precision with plain autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import default_jitter


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def add_jitter(K: torch.Tensor, jitter: Optional[float] = None) -> torch.Tensor:
    """Default jitter is relative to the mean diagonal (floored at the
    absolute value): an OAK Kuu tends to a rank-1 all-ones-like matrix as
    lengthscales grow, and an absolute 1e-5 is then below the f32 noise floor
    of the factorisation. An explicit ``jitter`` stays absolute."""
    if jitter is None:
        base = default_jitter(K.dtype)
        diag_scale = torch.clamp_min(
            torch.mean(torch.diagonal(K, dim1=-2, dim2=-1)), 1.0)
        return K + (base * diag_scale) * _eye_like(K)
    return K + jitter * _eye_like(K)


def cholesky(K: torch.Tensor, jitter: Optional[float] = None) -> torch.Tensor:
    return torch.linalg.cholesky(add_jitter(K, jitter))


def safe_cholesky(K: torch.Tensor, jitter: Optional[float] = None,
                  max_tries: int = 5) -> Tuple[torch.Tensor, float]:
    """Cholesky with deterministic jitter escalation.

    Tries jitter base·10^i for i = 0..max_tries-1 (base is the dtype's
    default, absolute) and returns (L, jitter) for the first that
    factorises. A try fails when ``cholesky_ex`` reports ``info != 0`` or L
    holds a NaN. If every try fails, L is all NaN, the JAX package's signal.
    Reading ``info`` synchronises with the device once per try."""
    base = default_jitter(K.dtype) if jitter is None else jitter
    eye = _eye_like(K)
    for i in range(max_tries):
        j = base * 10.0 ** i
        L, info = torch.linalg.cholesky_ex(K + j * eye)
        if bool((info == 0) & ~torch.isnan(L).any()):
            return L, j
    return torch.full_like(K, float("nan")), j


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻¹ B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻ᵀ B for lower-triangular L."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


def cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ B."""
    return solve_upper(L, solve_lower(L, B))


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
