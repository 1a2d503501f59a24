"""PSD linear algebra: jittered Cholesky, triangular solves and inverses
(``oak_tpu.ops.psd``, the part the SVGP paths use).

The TPU package's blocked Cholesky and triangular inverse, its custom VJPs
and its refined solves were written around XLA:TPU's serial, bf16-internal
solvers; here ``torch.linalg`` runs in full precision with plain autograd.

A Cholesky that fails returns NaN, as ``jnp.linalg.cholesky`` does, instead
of raising: a training step at the edge of the feasible region then
gives a non-finite loss, which the optimizers skip, and the card is not
synchronised to read the factorisation's status.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import default_jitter
from ..utils.profiling import spanned

# Each public call below is the span oak.linalg, one however they nest.
_linalg = spanned("oak.linalg")


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


def cholesky_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A (batched over leading dims); NaN in the
    lower triangle of a matrix that does not factorise, as JAX gives."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan).tril()


@_linalg
def cholesky(K: torch.Tensor, jitter: Optional[float] = None) -> torch.Tensor:
    return cholesky_lower(add_jitter(K, jitter))


@_linalg
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


@_linalg
def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻¹ B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


@_linalg
def solve_upper(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻ᵀ B for lower-triangular L."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


@_linalg
def tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """L⁻¹ for lower-triangular L (batched), by a triangular solve."""
    eye = _eye_like(L).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


@_linalg
def chol_of_inv(P: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular T with T Tᵀ = (P + jitter·I)⁻¹, batched, in one
    Cholesky and one triangular inverse by the reversal identity: with J the
    exchange matrix and Lr = chol(J P J), P⁻¹ = (J Lr⁻ᵀ J)(J Lr⁻¹ J), and
    J U J of an upper-triangular U is lower-triangular. The natural-gradient
    step turns a precision into a covariance factor with it."""
    Pr = torch.flip(P + jitter * _eye_like(P), dims=(-2, -1))
    Lr = cholesky_lower(Pr)
    return torch.flip(tri_inv_lower(Lr).mT, dims=(-2, -1))


@_linalg
def cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ B."""
    return solve_upper(L, solve_lower(L, B))


@_linalg
def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
