"""The lower triangle of a long-K product, C = α·tril(P Qᵀ) for P, Q
[..., M, K] with K ≫ M, or the symmetric C = α·P Pᵀ written whole, and the
wrapper of its CUDA kernel ``csrc/gemmt.cu``. The training bounds take it
where they need only one triangle of an M × M product over their N rows: the
SGPR bound's AAᵀ (``SymProduct``) and the wide solve's backward
dL = −tril(dB Xᵀ) (``ops.tri_solve.TriSolve``).

``gemmt_op`` is the registered op ``torch.ops.oak_tpu_torch.gemmt``: it
launches the kernel for float32 CUDA tensors, one launch for every matrix
of the leading dims, and raises for any other CUDA dtype; its CPU
implementation is the plain version ``gemmt_plain``. Its
``torch.func.vmap`` rule folds the lanes of a multistart into that launch.
``gemmt`` routes a float64 CUDA input to the library's product, as the
solve's callers do (``routes.own_route``). ``Gemmt`` and ``SymProduct`` give it
autograd, differentiable to any order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import _build
from ..utils import profiling
from .routes import lanes_first, own_route


def _mirrored(X: torch.Tensor) -> torch.Tensor:
    """X's lower triangle, mirrored onto its upper one: exactly symmetric."""
    M = X.shape[-1]
    lower = torch.ones(M, M, dtype=torch.bool, device=X.device).tril()
    return torch.where(lower, X, X.mT)


def gemmt_plain(P: torch.Tensor, Q: torch.Tensor, alpha: float = 1.0,
                symmetric: bool = False) -> torch.Tensor:
    """α·tril(P Qᵀ), or with ``symmetric`` α·P Pᵀ (Q is P) mirrored from its
    lower triangle, in any dtype, broadcasting over leading lane axes: the
    CPU route and the version the kernel is checked against."""
    if symmetric:
        return alpha * _mirrored(P @ P.mT)
    return alpha * torch.tril(P @ Q.mT)


@functools.lru_cache(maxsize=None)
def _split(M: int, K: int, lanes: int, device: torch.device) -> int:
    """The kernel's split of K (blocks of a cluster) for these shapes on
    ``device``."""
    split = ctypes.c_int()
    with torch.cuda.device(device):
        rc = _build.library().oak_gemmt_plan(M, K, lanes, ctypes.byref(split))
    if rc != 0:
        raise RuntimeError(f"oak_gemmt_plan({M}, {K}, {lanes}) failed with cudaError {rc}")
    return split.value


def _check(P: torch.Tensor, Q: torch.Tensor, lanes: int, batched: Sequence[bool]) -> None:
    for name, t, lead in (("P", P, batched[0]), ("Q", Q, batched[1])):
        if not t.is_cuda:
            raise ValueError(f"gemmt: {name} is on {t.device}, the other on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"gemmt: {name} is {t.dtype}; the CUDA kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"gemmt: {name} is not contiguous")
        if t.dim() != 2 + bool(lanes and lead) or (lanes and lead and t.shape[0] != lanes):
            raise ValueError(f"gemmt: {name} has shape {tuple(t.shape)}"
                             + (f", expected {lanes} lanes first" if lanes and lead else ""))
    if P.device != Q.device:
        raise ValueError("gemmt: P and Q lie on different devices")
    if P.shape[-2:] != Q.shape[-2:]:
        raise ValueError(f"gemmt: P {tuple(P.shape)} and Q {tuple(Q.shape)} differ in shape")


def _launch(P: torch.Tensor, Q: torch.Tensor, alpha: float, symmetric: bool, lanes: int = 0,
            batched: Sequence[bool] = (True, True)) -> torch.Tensor:
    """``oak_gemmt_f32`` after ``_check``: C [M, M], or with ``lanes`` > 0
    the lanes' C [lanes, M, M] in one launch, P and Q each with a leading
    lane axis where ``batched`` says so and shared by every lane otherwise."""
    _check(P, Q, lanes, batched)
    M, K = P.shape[-2:]
    out = torch.empty(((lanes,) if lanes else ()) + (M, M), dtype=torch.float32,
                      device=P.device)
    if M == 0:
        return out
    split = _split(M, K, max(lanes, 1), P.device)
    with torch.cuda.device(P.device):
        rc = _build.library().oak_gemmt_f32(
            P.data_ptr(), Q.data_ptr(), out.data_ptr(), M, K, max(lanes, 1), float(alpha),
            int(symmetric), split, M * K if lanes and batched[0] else 0,
            M * K if lanes and batched[1] else 0,
            torch.cuda.current_stream(P.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"oak_gemmt_f32 launch failed with cudaError {rc}")
    profiling.count("gemmt.launches")
    return out


def _folded(P: torch.Tensor, Q: torch.Tensor, alpha: float, symmetric: bool) -> torch.Tensor:
    """``_launch`` for P and Q [..., M, K] whose leading dims broadcast: they
    fold into the kernel's one lane axis, so one launch computes them all,
    and an operand whose leading dims hold one matrix is shared by every
    lane. C has the broadcast leading dims."""
    lead = torch.broadcast_shapes(P.shape[:-2], Q.shape[:-2])
    lanes = lead.numel()
    M = P.shape[-2]
    if lanes == 0:
        return P.new_empty(lead + (M, M))
    ops, batched = [], []
    for t in (P, Q):
        shared = t.shape[:-2].numel() == 1
        core = t.shape[-2:]
        ops.append((t.reshape(core) if shared
                    else t.expand(lead + core).reshape((lanes,) + core)).contiguous())
        batched.append(not shared)
    if symmetric:
        ops[1], batched[1] = ops[0], batched[0]
    C = _launch(*ops, alpha, symmetric, lanes if any(batched) else 0, batched)
    return C.reshape(lead + (M, M))


@torch.library.custom_op("oak_tpu_torch::gemmt", mutates_args=(), device_types="cuda")
def gemmt_op(P: torch.Tensor, Q: torch.Tensor, alpha: float, symmetric: bool) -> torch.Tensor:
    """α·tril(P Qᵀ), or α·P Pᵀ mirrored with ``symmetric`` (Q is then not
    read), for P and Q [..., M, K] whose leading dims broadcast, as a
    registered op: on CUDA tensors the kernel, one launch for every matrix of
    the leading dims (float32, or raise; the counter ``gemmt.launches``
    counts it), on CPU tensors ``gemmt_plain``. No autograd of its own:
    ``Gemmt`` and ``SymProduct`` give it one. Under ``torch.func.vmap`` its
    rule folds the lanes into that launch."""
    return _folded(P, Q, alpha, symmetric)


@gemmt_op.register_kernel("cpu")
def _gemmt_cpu(P, Q, alpha, symmetric):
    return gemmt_plain(P, Q, alpha, symmetric).contiguous()


@gemmt_op.register_fake
def _gemmt_fake(P, Q, alpha, symmetric):
    M = P.shape[-2]
    return P.new_empty(torch.broadcast_shapes(P.shape[:-2], Q.shape[:-2]) + (M, M))


@gemmt_op.register_vmap
def _gemmt_vmap(info, in_dims, P, Q, alpha, symmetric):
    """The lanes' C [lanes, ..., M, M]: on CUDA one launch for the lanes and
    any leading dims of a lane, on the CPU one plain call."""
    P, Q = lanes_first(in_dims[:2], P, Q)
    return (_folded if P.is_cuda or Q.is_cuda else _gemmt_cpu)(P, Q, alpha, symmetric), 0


def gemmt(P: torch.Tensor, Q: torch.Tensor, alpha: float = 1.0,
          symmetric: bool = False) -> torch.Tensor:
    """``gemmt_op`` where its routes take P (``routes.own_route``), the
    library's product (``gemmt_plain``) for a float64 CUDA P."""
    if not own_route(P):
        return gemmt_plain(P, Q, alpha, symmetric)
    return gemmt_op(P.contiguous(), Q.contiguous(), alpha, symmetric)


class Gemmt(torch.autograd.Function):
    """C = α·tril(P Qᵀ) through ``gemmt``, differentiable to any order: with
    G̃ = tril(G), dP = α G̃ Q and dQ = α G̃ᵀ P, plain products that autograd
    differentiates again. Its ``vmap`` rule applies it once to the
    lane-batched tensors, so that the lanes launch the kernel once."""

    @staticmethod
    def forward(P, Q, alpha):
        return gemmt(P, Q, alpha)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.alpha = inputs[2]
        ctx.save_for_backward(inputs[0], inputs[1])

    @staticmethod
    def backward(ctx, G):
        P, Q = ctx.saved_tensors
        need_P, need_Q, _ = ctx.needs_input_grad
        G = ctx.alpha * torch.tril(G)
        return G @ Q if need_P else None, G.mT @ P if need_Q else None, None

    @staticmethod
    def vmap(info, in_dims, P, Q, alpha):
        return Gemmt.apply(*lanes_first(in_dims[:2], P, Q), alpha), 0


class SymProduct(torch.autograd.Function):
    """S = A Aᵀ for A [..., M, K], through ``gemmt``'s symmetric form (one
    triangle computed, mirrored), differentiable to any order: the backward
    is one product, dA = (G + Gᵀ) A. Its ``vmap`` rule applies it once to
    the lane-batched A."""

    @staticmethod
    def forward(A):
        return gemmt(A, A, 1.0, symmetric=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, G):
        (A,) = ctx.saved_tensors
        return (G + G.mT) @ A

    @staticmethod
    def vmap(info, in_dims, A):
        return SymProduct.apply(A.movedim(in_dims[0], 0)), 0
