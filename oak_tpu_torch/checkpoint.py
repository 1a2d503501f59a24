"""The parameter bridge: keypath npz files shared with ``oak_tpu``.

``oak_tpu.checkpoint.save_params`` writes one array per pytree leaf, keyed
``m`` + the leaf's JAX key path (``m.kernel.kernels[0].lengthscale.raw``).
``load_params`` fills a port model built with the same structure from such a
file ("rebuild, then load"), reading it with numpy alone; ``save_params``
writes the same keys from a port model.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from .params import Param, keypath_nodes

PREFIX = "m"


def _leaves(model: nn.Module) -> Dict[str, torch.Tensor]:
    out = {}
    for key, node in keypath_nodes(model):
        if isinstance(node, Param):
            out[f"{PREFIX}{key}.raw"] = node.raw
        else:
            out[f"{PREFIX}{key}"] = node
    return out


def save_params(model: nn.Module, path) -> None:
    """Save every array leaf of ``model`` under its JAX key path."""
    np.savez(path, **{k: t.detach().cpu().numpy() for k, t in _leaves(model).items()})


@torch.no_grad()
def load_params(model: nn.Module, path_or_mapping: Union[str, Mapping]) -> nn.Module:
    """Fill ``model``'s raw values and buffers in place from a keypath npz
    (or a mapping of the same keys), casting to each tensor's dtype and
    device. A missing key, an extra key or a shape mismatch raises."""
    if isinstance(path_or_mapping, Mapping):
        data = dict(path_or_mapping)
    else:
        with np.load(path_or_mapping) as f:
            data = {k: f[k] for k in f.files}
    leaves = _leaves(model)
    missing = sorted(set(leaves) - set(data))
    extra = sorted(set(data) - set(leaves))
    if missing or extra:
        raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for key, t in leaves.items():
        arr = np.array(data[key])  # a writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, model shape "
                             f"{tuple(t.shape)}")
        t.copy_(torch.as_tensor(arr).to(dtype=t.dtype, device=t.device))
    return model
