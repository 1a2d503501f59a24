"""What the hand-written linear-algebra ops (``ops.tri_solve``,
``ops.gemmt``) share: which tensors their own routes take, and the layout in
which their ``torch.func.vmap`` rules hand the lanes to one launch."""

from __future__ import annotations

import torch


def own_route(t: torch.Tensor) -> bool:
    """Whether an op's own routes take t: on the CPU the plain version; on
    CUDA anything but float64, which the callers leave to the library
    (float32 launches the kernel, any other dtype raises in the op)."""
    return not t.is_cuda or t.dtype != torch.float64


def lanes_first(in_dims, *ts: torch.Tensor):
    """The tensors a ``torch.func.vmap`` rule is handed, as the physical
    operands of one lane-batched call: the lane axis first (a 1 where a
    tensor has none), and each tensor's own leading dims aligned right
    behind it (1s where it has fewer), so that they broadcast against each
    other as the logical tensors do."""
    own = [t.dim() - 2 - (d is not None) for t, d in zip(ts, in_dims)]
    out = []
    for t, d, k in zip(ts, in_dims, own):
        t = t.unsqueeze(0) if d is None else t.movedim(d, 0)
        out.append(t.reshape(t.shape[:1] + (1,) * (max(own) - k) + t.shape[1:]))
    return out
