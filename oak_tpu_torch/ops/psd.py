"""PSD linear algebra: jittered Cholesky, triangular solves and inverses
(``oak_tpu.ops.psd``, the part the SVGP paths use).

The TPU package's blocked Cholesky and triangular inverse and its refined
solves were written around XLA:TPU's serial, bf16-internal solvers; here
``torch.linalg`` runs in full precision. The Cholesky's reverse pass is the
package's own where its two triangular solves can run on the card's solve
kernel (``CholeskyLower``, ``CholeskyVjp``); elsewhere autograd's.

A Cholesky that fails returns NaN, as ``jnp.linalg.cholesky`` does, instead
of raising: a training step at the edge of the feasible region then
gives a non-finite loss, which the optimizers skip, and the card is not
synchronised to read the factorisation's status.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import default_jitter
from ..utils import profiling
from ..utils.profiling import spanned
from . import routes, tri_solve
from .tri_solve import TriSolve

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


def _phi(X: torch.Tensor) -> torch.Tensor:
    """The lower triangle of X with its diagonal halved."""
    T = torch.tril(X)
    return T - 0.5 * torch.diag_embed(torch.diagonal(T, dim1=-2, dim2=-1))


class CholeskyLower(torch.autograd.Function):
    """``torch.linalg.cholesky_ex``'s (L, info), whose reverse pass is
    ``CholeskyVjp``; ``info`` is not differentiable. ``setup_context`` lets
    ``torch.func`` take it, and its ``vmap`` rule factors the lanes in one
    call."""

    @staticmethod
    def forward(A):
        L, info = torch.linalg.cholesky_ex(A)
        return L, info  # a tuple: torch.func cannot unpack the named one

    @staticmethod
    def setup_context(ctx, inputs, output):
        L, info = output
        ctx.mark_non_differentiable(info)
        ctx.save_for_backward(L)

    @staticmethod
    def backward(ctx, gL, _):
        (L,) = ctx.saved_tensors
        return CholeskyVjp.apply(L, gL)

    @staticmethod
    def vmap(info, in_dims, A):
        return CholeskyLower.apply(A.movedim(in_dims[0], 0)), (0, 0)


class CholeskyVjp(torch.autograd.Function):
    """The Cholesky's reverse pass gA for a factor L and its cotangent gL
    (Murray 2016, eq. 8; ``oak_tpu``'s ``_cholesky_lower_bwd``):

        P  = Φ(Lᵀ gL)   (the lower triangle, its diagonal halved)
        Y  = L⁻ᵀ P,  S = L⁻ᵀ Yᵀ  (= L⁻ᵀ Pᵀ L⁻¹)
        gA = ½ (S + Sᵀ)

    whose two solves are the solve op's transposed form: on a float32 CUDA
    L the kernel ``csrc/tri_solve.cu``, one launch for every lane, on the
    CPU ``solve_triangular``. Each pass opens ``oak.linalg`` and counts
    ``chol.vjp``. It is one Function with a ``vmap`` rule of its own, so a
    vmapped reverse pass costs the host one Function at each transform
    level. Its backward, for second derivatives, takes H = sym(ggA):
    V = L⁻¹H, R = Φ(L⁻¹Vᵀ), dgL = L R, dL = gL Rᵀ − 2 tril(gA Vᵀ), through
    ``TriSolve``, so it is differentiable again."""

    @staticmethod
    def forward(L, gL):
        with profiling.trace_annotation("oak.linalg"):
            profiling.count("chol.vjp")
            L = L.contiguous()
            Y = tri_solve.tri_solve_op(L, _phi(L.mT @ gL), True)
            S = tri_solve.tri_solve_op(L, Y.mT.contiguous(), True)
            return 0.5 * (S + S.mT)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, H):
        L, gL, gA = ctx.saved_tensors
        need_L, need_gL = ctx.needs_input_grad
        with profiling.trace_annotation("oak.linalg"):
            L = L.contiguous()
            V = TriSolve.apply(L, (0.5 * (H + H.mT)).contiguous(), False)
            R = _phi(TriSolve.apply(L, V.mT.contiguous(), False))
            dL = gL @ R.mT - 2.0 * torch.tril(gA @ V.mT) if need_L else None
            return dL, L @ R if need_gL else None

    @staticmethod
    def vmap(info, in_dims, L, gL):
        return CholeskyVjp.apply(*routes.lanes_first(in_dims, L, gL)), 0


def _own_vjp(A: torch.Tensor) -> bool:
    """Whether ``cholesky_lower`` takes ``CholeskyLower``: where a gradient
    may be taken through A (grad mode on, and A requires grad or is batched
    by ``torch.func.vmap``, as ``oak_gram.fused_op`` reads it) and the solve
    op takes its factor within one panel (``tri_solve.takes``): on the CPU,
    or on the card a factor whose rows fit one panel of the kernel. A
    float64 CUDA A and a taller one (the GPR's N x N factor) keep autograd's
    backward."""
    return (torch.is_grad_enabled()
            and (A.requires_grad or torch._C._functorch.is_batchedtensor(A))
            and tri_solve.takes(A, one_panel=True))


def cholesky_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A (batched over leading dims); NaN in the
    lower triangle of a matrix that does not factorise, as JAX gives. The
    factor is ``cholesky_ex``'s whichever backward ``_own_vjp`` picks."""
    L, info = CholeskyLower.apply(A) if _own_vjp(A) else torch.linalg.cholesky_ex(A)
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
def solve_lower_wide(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻¹ B for lower-triangular L and a wide B, the training bounds'
    L⁻¹Kuf, differentiable in both: ``ops.tri_solve.TriSolve``, whose
    float32 CUDA route is the kernel ``csrc/tri_solve.cu``, forward and
    backward, and whose CPU route is ``solve_triangular``. A float64 CUDA
    input takes ``solve_lower``'s library solve, as the gram's routing does;
    the op raises for any other CUDA dtype."""
    if not tri_solve.takes(L):
        return torch.linalg.solve_triangular(L, B, upper=False)
    return TriSolve.apply(L.contiguous(), B.contiguous(), False)


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
