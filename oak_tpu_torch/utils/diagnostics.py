"""Input checks (``oak_tpu.utils.diagnostics``, the part the predict path uses)."""

from __future__ import annotations

import torch


def check_matrix_input(X: torch.Tensor, num_dims: int, name: str = "X") -> None:
    """Kernel-entry gate: 2-D with enough columns for every active dim."""
    shape = tuple(X.shape)
    if len(shape) != 2:
        raise ValueError(f"{name} must be 2-D [N, D], got shape {shape}")
    if shape[1] < num_dims:
        raise ValueError(
            f"{name} has {shape[1]} columns but the kernel's active dims "
            f"need at least {num_dims}")
