"""The triangular solve with a wide right-hand side that the training bounds
take, A = L⁻¹B for a lower-triangular L [M, M] and B [M, N] with N ≫ M
(L⁻¹Kuf), and the wrapper of its CUDA kernel ``csrc/tri_solve.cu``. The
Cholesky's reverse pass (``ops.psd.CholeskyLower``) takes its transposed form
with a square right-hand side.

``TriSolve`` is a ``torch.autograd.Function``, differentiable to any
order: its forward is the registered op ``torch.ops.oak_tpu_torch.tri_solve``,
its backward dB = L⁻ᵀdA the op's other form, through ``TriSolve`` again, and
dL = −tril(dB Aᵀ) the lower triangle of a long product alone, through
``ops.gemmt.Gemmt``; ``ops.psd.solve_lower_wide`` applies it.
The op launches the kernel for float32 CUDA tensors, at any width, and raises
for any other CUDA dtype; its CPU implementation is the plain version,
``torch.linalg.solve_triangular``. Its ``torch.func.vmap`` rule runs all
lanes of a multistart in one launch, as the gram ops' rules do. The
prediction paths keep ``ops.psd.solve_lower``: a served request is one row
wide, and the exported package loads with torch alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import _build
from ..utils import profiling
from . import gemmt
from .routes import lanes_first, own_route


def tri_solve_plain(L: torch.Tensor, B: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """L⁻¹B, or L⁻ᵀB with ``transpose``, for lower-triangular L, in any
    dtype, broadcasting over leading lane axes: the CPU route and the
    version the kernel is checked against."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


@functools.lru_cache(maxsize=None)
def _panel(M: int, N: int, lanes: int, device: torch.device) -> int:
    """The kernel's panel width for these shapes on ``device`` (0: M is too
    tall for a panel's shared memory)."""
    nb = ctypes.c_int()
    with torch.cuda.device(device):
        rc = _build.library().oak_tri_solve_panel(M, N, lanes, ctypes.byref(nb))
    if rc != 0:
        raise RuntimeError(f"oak_tri_solve_panel({M}, {N}, {lanes}) failed with cudaError {rc}")
    return nb.value


def takes(L: torch.Tensor, one_panel: bool = False) -> bool:
    """Whether the op's own routes take L (``routes.own_route``). With
    ``one_panel`` a CUDA L must also fit one panel of the kernel's shared
    memory (M ≤ 1,504 on an H100), which a taller L would only reach by
    ``_split``'s products."""
    if not own_route(L):
        return False
    return not L.is_cuda or not one_panel or _panel(L.shape[-1], L.shape[-1], 1, L.device) != 0


def _check(L: torch.Tensor, B: torch.Tensor, lanes: int, batched: Sequence[bool]) -> None:
    for name, t, lead in (("L", L, batched[0]), ("B", B, batched[1])):
        if not t.is_cuda:
            raise ValueError(f"tri_solve: {name} is on {t.device}, the other on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"tri_solve: {name} is {t.dtype}; the CUDA kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"tri_solve: {name} is not contiguous")
        if t.dim() != 2 + bool(lanes and lead) or (lanes and lead and t.shape[0] != lanes):
            raise ValueError(f"tri_solve: {name} has shape {tuple(t.shape)}"
                             + (f", expected {lanes} lanes first" if lanes and lead else ""))
    if L.device != B.device:
        raise ValueError("tri_solve: L and B lie on different devices")
    M = L.shape[-1]
    if L.shape[-2] != M or B.shape[-2] != M:
        raise ValueError(f"tri_solve: L {tuple(L.shape)} is not square or does not match "
                         f"B {tuple(B.shape)}")


def _launch(L: torch.Tensor, B: torch.Tensor, transpose: bool, lanes: int = 0,
            batched: Sequence[bool] = (True, True)) -> torch.Tensor:
    """``oak_tri_solve_f32`` after ``_check``: X [M, N], or with ``lanes``
    > 0 the lanes' X [lanes, M, N] in one launch, L and B each with a
    leading lane axis where ``batched`` says so and shared by every lane
    otherwise. An L too tall for the kernel's shared memory is split in
    two, the off-diagonal block's product by ``torch.matmul``."""
    _check(L, B, lanes, batched)
    M, N = L.shape[-1], B.shape[-1]
    lanes_L = lanes if lanes and batched[0] else 1
    out = torch.empty(((lanes,) if lanes else ()) + (M, N), dtype=torch.float32,
                      device=B.device)
    if M == 0 or N == 0:
        return out
    nb = _panel(M, N, max(lanes, 1), B.device)
    if nb == 0:
        return _split(L, B, transpose, lanes, batched)
    lib = _build.library()
    work = torch.empty((lib.oak_tri_solve_workspace(M, lanes_L),), dtype=torch.float32,
                       device=B.device)
    with torch.cuda.device(B.device):
        rc = lib.oak_tri_solve_f32(
            L.data_ptr(), B.data_ptr(), out.data_ptr(), work.data_ptr(), M, N,
            max(lanes, 1), lanes_L, int(transpose), nb, M * M if lanes_L > 1 else 0,
            M * N if lanes and batched[1] else 0,
            torch.cuda.current_stream(B.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"oak_tri_solve_f32 launch failed with cudaError {rc}")
    profiling.count("solve.launches")
    return out


def _split(L, B, transpose, lanes, batched):
    """The solve of an L too tall for one panel, by the 2 x 2 blocks of L:
    X₁ = L₁₁⁻¹B₁, X₂ = L₂₂⁻¹(B₂ − L₂₁X₁); transposed X₂ = L₂₂⁻ᵀB₂,
    X₁ = L₁₁⁻ᵀ(B₁ − L₂₁ᵀX₂). The split falls on a multiple of 32 rows."""
    h = (L.shape[-1] // 64) * 32
    L11, L21, L22 = (L[..., :h, :h].contiguous(), L[..., h:, :h],
                     L[..., h:, h:].contiguous())
    B1, B2 = B[..., :h, :].contiguous(), B[..., h:, :].contiguous()
    if transpose:
        X2 = _launch(L22, B2, True, lanes, batched)
        X1 = _launch(L11, (B1 - L21.mT @ X2).contiguous(), True, lanes, (batched[0], True))
    else:
        X1 = _launch(L11, B1, False, lanes, batched)
        X2 = _launch(L22, (B2 - L21 @ X1).contiguous(), False, lanes, (batched[0], True))
    return torch.cat([X1, X2], dim=-2)


def _folded(L: torch.Tensor, B: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``_launch`` for L [..., M, M] and B [..., M, N] whose leading dims
    broadcast: they fold into the kernel's one lane axis, so one launch
    solves them all, and an operand whose leading dims hold one matrix is
    shared by every lane. X has the broadcast leading dims."""
    lead = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    lanes = lead.numel()
    if lanes == 0:
        return B.new_empty(lead + B.shape[-2:])
    ops, batched = [], []
    for t in (L, B):
        shared = t.shape[:-2].numel() == 1
        core = t.shape[-2:]
        ops.append((t.reshape(core) if shared
                    else t.expand(lead + core).reshape((lanes,) + core)).contiguous())
        batched.append(not shared)
    X = _launch(*ops, transpose, lanes if any(batched) else 0, batched)
    return X.reshape(lead + X.shape[-2:])


@torch.library.custom_op("oak_tpu_torch::tri_solve", mutates_args=(), device_types="cuda")
def tri_solve_op(L: torch.Tensor, B: torch.Tensor, transpose: bool) -> torch.Tensor:
    """L⁻¹B, or L⁻ᵀB with ``transpose``, for lower-triangular L [..., M, M]
    and B [..., M, N] whose leading dims broadcast, as a registered op: on
    CUDA tensors the kernel, one launch for every matrix of the leading dims
    (float32, or raise; the counter ``solve.launches`` counts it, its
    diagonal blocks' inversion and its panel kernel once), on CPU tensors
    ``tri_solve_plain``. No autograd of its own: ``TriSolve`` gives it one.
    Under ``torch.func.vmap`` its rule folds the lanes into that launch."""
    return _folded(L, B, transpose)


@tri_solve_op.register_kernel("cpu")
def _tri_solve_cpu(L, B, transpose):
    # row-major, as the kernel's output and the fake are (LAPACK's is not)
    return tri_solve_plain(L, B, transpose).contiguous()


@tri_solve_op.register_fake
def _tri_solve_fake(L, B, transpose):
    return B.new_empty(torch.broadcast_shapes(L.shape[:-2], B.shape[:-2]) + B.shape[-2:])


@tri_solve_op.register_vmap
def _tri_solve_vmap(info, in_dims, L, B, transpose):
    """The lanes' X [lanes, ..., M, N]: on CUDA one launch for the lanes and
    any leading dims of a lane, on the CPU one plain call."""
    L, B = lanes_first(in_dims[:2], L, B)
    return (_folded if L.is_cuda or B.is_cuda else _tri_solve_cpu)(L, B, transpose), 0


class TriSolve(torch.autograd.Function):
    """X = L⁻¹B, or L⁻ᵀB with ``transpose``, through the registered op,
    differentiable to any order: the backward is the other form,
    dB = L⁻ᵀdX (L⁻¹dX) through ``TriSolve`` itself, and dL = −tril(dB Xᵀ)
    (−tril(X dBᵀ)) through ``gemmt.Gemmt``, which computes that triangle
    alone.

    It composes with ``torch.func``: ``setup_context`` lets ``grad`` take
    it, and its ``vmap`` rule applies it once to the lane-batched tensors,
    so forward and backward launch the kernel once for every lane."""

    @staticmethod
    def forward(L, B, transpose):
        return tri_solve_op(L, B, transpose)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.transpose = inputs[2]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, dX):
        L, X = ctx.saved_tensors
        need_L, need_B, _ = ctx.needs_input_grad
        with profiling.trace_annotation("oak.linalg"):
            dB = TriSolve.apply(L, dX.contiguous(), not ctx.transpose)
            dL = None
            if need_L:
                dL = gemmt.Gemmt.apply(*((X, dB) if ctx.transpose else (dB, X)), -1.0)
        return dL, dB if need_B else None, None

    @staticmethod
    def vmap(info, in_dims, L, B, transpose):
        return TriSolve.apply(*lanes_first(in_dims[:2], L, B), transpose), 0
