"""One module per model kind of a configuration (its ``model`` key): the
inputs a seed gives, the port's model built on them, its dtype, and its
trainable leaves named as the reference names them (``leaves``, ``split``
and ``join`` here, shared by the kinds)."""

from __future__ import annotations

import re
from typing import Dict

import torch

_LEAF = [(re.compile(r"kernel\.kernels\.(\d+)\.lengthscale\.raw"), "lengthscale.{}"),
         (re.compile(r"kernel\.variances\.(\d+)\.raw"), "variance.{}"),
         (re.compile(r"likelihood\.variance\.raw"), "noise"),
         (re.compile(r"q_mu\.raw"), "q_mu"),
         (re.compile(r"q_sqrt\.raw"), "q_sqrt")]
# the reference's vectors that the program holds one Param per entry of
_PER_ENTRY = ("lengthscale", "variance")


def dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def leaves(model, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The trainable vector ``vec`` [n] cut into the model's leaves, in the
    program's order, named as ``split`` names the reference's."""
    from oak_tpu_torch.params import trainable_names, trainable_params

    sizes = [p.raw.numel() for p in trainable_params(model)]
    out = {}
    for name, piece in zip(trainable_names(model), torch.split(vec.reshape(-1), sizes)):
        for pattern, fmt in _LEAF:
            m = pattern.fullmatch(name)
            if m:
                out[fmt.format(*m.groups())] = piece.detach().reshape(-1).cpu()
                break
        else:
            raise KeyError(f"no reference leaf for the trainable {name}")
    return out


def split(ref: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's leaves at the program's grain: one per dim's
    lengthscale and per order's variance."""
    out = {}
    for k, v in ref.items():
        if k in _PER_ENTRY:
            out.update({f"{k}.{i}": v[i].reshape(1).cpu() for i in range(v.shape[0])})
        else:
            out[k] = v.reshape(-1).cpu()
    return out


def join(leaves_: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``split``'s inverse: the per-entry leaves back into the reference's
    vectors, shaped and placed as ``like``."""
    out = {}
    for k, v in like.items():
        if k in _PER_ENTRY:
            out[k] = torch.cat([leaves_[f"{k}.{i}"] for i in range(v.shape[0])]).to(v)
        else:
            out[k] = leaves_[k].reshape(v.shape).to(v)
    return out
