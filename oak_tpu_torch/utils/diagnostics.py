"""Numerical-health diagnostics (``oak_tpu.utils.diagnostics``):

- ``assert_finite(obj, name)``: host-side check of every floating tensor of a
  module, or of a dict, list or tuple of tensors; raises with the paths of
  the non-finite ones;
- ``finite_or_debug(x, name)``: the identity, printing when x has
  non-finite entries;
- ``checked(fn)``: ``fn`` under a dispatch mode that checks the floating
  output of every op it runs, its backward's included; a NaN or inf raises
  on the host and names the first op that made one (``oak_tpu``'s checkify);
- ``cholesky_health(K)``: a conditioning report of a PSD matrix;
- ``check_matrix_input``: the kernel-entry shape gate.

The jitter escalation itself is ``ops.psd.safe_cholesky``.
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode


def _named_tensors(obj, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of obj. A module of the port's model
    classes is walked by its JAX key paths (``params.keypath_nodes``), so a
    path reads like ``oak_tpu``'s ``keystr`` (``.kernel.kernels[0].
    lengthscale.raw``); any other module by its attribute names."""
    from ..params import Param, keypath_nodes

    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, nn.Module):
        try:
            nodes = keypath_nodes(obj)
        except AttributeError:  # a module without _fields somewhere below
            for name, t in obj.named_parameters():
                yield f"{path}.{name}", t
            for name, t in obj.named_buffers():
                yield f"{path}.{name}", t
            return
        for key, node in nodes:
            if isinstance(node, Param):
                yield f"{path}{key}.raw", node.raw
            else:
                yield f"{path}{key}", node
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _named_tensors(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _named_tensors(v, f"{path}[{i}]")


def assert_finite(obj, name: str = "tree") -> None:
    """Raise FloatingPointError listing every non-finite floating tensor of
    ``obj`` by its path. One host synchronisation for the whole check."""
    named = [(p, t) for p, t in _named_tensors(obj) if t.is_floating_point()]
    if not named:
        return
    with torch.no_grad():
        flags = _on_host([torch.isfinite(t.detach()).all() for _, t in named])
    bad = [p for (p, _), ok in zip(named, flags.tolist()) if not ok]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def _on_host(flags: List[torch.Tensor]) -> torch.Tensor:
    """0-dim flags, possibly on several devices, as one host vector, read in
    one copy from the first flag's device."""
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).cpu()


def finite_or_debug(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """The identity; prints ``[oak-tpu] non-finite in {name}: {n}`` when x
    has n > 0 non-finite entries (a host synchronisation on the card)."""
    n_bad = int(torch.sum(~torch.isfinite(x.detach())))
    if n_bad > 0:
        print(f"[oak-tpu] non-finite in {name}: {n_bad}")
    return x


# Ops whose output is not checked. Allocations: their memory has not been
# written yet (the port's CUDA backward allocates its outputs with
# torch.empty and a ctypes launch fills them outside any op, so reading them
# here would read uninitialised memory). Fills, selections and copies: they
# produce no value, they pass on what they were given (a NaN literal that
# ``torch.where`` keeps for a failed Cholesky is not a NaN made by an op;
# the first op that computes with it is checked). Views are skipped too.
_aten = torch.ops.aten
_NOT_CHECKED = frozenset(getattr(_aten, name) for name in (
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "empty_permuted",
    "scalar_tensor", "full", "full_like", "new_full", "fill", "fill_", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "lift_fresh_copy",
    "where", "masked_fill", "masked_fill_", "index", "index_select", "gather", "index_put",
    "index_put_", "select_scatter", "slice_scatter", "diagonal_scatter", "tril", "triu",
    "copy", "copy_", "clone", "_to_copy", "cat", "stack", "expand_copy", "repeat",
))
_KINDS = {"nan": torch.isnan, "inf": torch.isinf}


class _NonFiniteMode(TorchDispatchMode):
    """Records, per op run under it, whether a floating output holds a
    value of the checked kinds. The flags stay on the device and are read
    once, when ``checked``'s call ends. Views and the ops of _NOT_CHECKED
    are not checked."""

    def __init__(self, kinds: Tuple[str, ...]):
        super().__init__()
        self.kinds = kinds
        self.flags: List[Tuple[str, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _NOT_CHECKED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.layout == torch.strided and t.device.type != "meta"
                    and t.numel() > 0):
                bad = functools.reduce(torch.logical_or,
                                       (_KINDS[k](t).any() for k in self.kinds))
                self.flags.append((str(func), bad))
        return out

    def first_bad(self) -> Optional[Tuple[int, str]]:
        if not self.flags:
            return None
        bad = _on_host([f for _, f in self.flags])
        hits = torch.nonzero(bad).reshape(-1)
        if hits.numel() == 0:
            return None
        i = int(hits[0])
        return i, self.flags[i][0]


def checked(fn, errors=None):
    """``fn`` with every op it runs checked for NaN and inf: the counterpart
    of ``oak_tpu``'s checkify wrapper. Each floating output of each op that
    computes under ``fn`` (a registered op such as
    ``oak_tpu_torch::oak_gram_fwd``, and the ops of a backward that ``fn``
    runs, included; not the ops that only allocate, fill, select or copy) is
    tested on its device; when ``fn`` returns, the flags are read in one
    host synchronisation and the first op whose output holds a non-finite
    value raises FloatingPointError with its name. ``errors``: the kinds
    that raise, a subset of ``("nan", "inf")``; None is both.

        loss_and_grad = checked(lambda: torch.autograd.grad(model.training_loss(), raws))
    """
    kinds = ("nan", "inf") if errors is None else tuple(errors)
    if not kinds or set(kinds) - set(_KINDS):
        raise ValueError(f"errors must be a non-empty subset of {tuple(_KINDS)}, got {errors!r}")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mode = _NonFiniteMode(kinds)
        with mode:
            out = fn(*args, **kwargs)
        hit = mode.first_bad()
        if hit is not None:
            i, op = hit
            raise FloatingPointError(
                f"non-finite value ({'/'.join(kinds)}) made by {op}, op {i + 1} of "
                f"{len(mode.flags)} checked inside {getattr(fn, '__name__', 'fn')}")
        return out

    return wrapper


def check_matrix_input(X: torch.Tensor, num_dims: int, name: str = "X") -> None:
    """Kernel-entry gate: 2-D with enough columns for every active dim."""
    shape = tuple(X.shape)
    if len(shape) != 2:
        raise ValueError(f"{name} must be 2-D [N, D], got shape {shape}")
    if shape[1] < num_dims:
        raise ValueError(
            f"{name} has {shape[1]} columns but the kernel's active dims "
            f"need at least {num_dims}")


def cholesky_health(K) -> dict:
    """Conditioning report of a PSD matrix, computed from a host copy in
    K's dtype (``oak_tpu``'s dict)."""
    K = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    diag = np.diagonal(K)
    eigs = np.linalg.eigvalsh((K + K.T) / 2)
    return {
        "n": K.shape[0],
        "diag_min": float(diag.min()),
        "diag_mean": float(diag.mean()),
        "eig_min": float(eigs.min()),
        "eig_max": float(eigs.max()),
        "condition": float(eigs.max() / max(eigs.min(), 1e-300)),
        "finite": bool(np.isfinite(K).all()),
    }
