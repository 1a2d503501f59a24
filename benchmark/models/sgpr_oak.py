"""The reference's UCI pumadyn setting through the port's ``oak_model``:
flows on every input, the targets standardised, k-means inducing points,
SGPR over the OAK kernel with shared variances across orders and the
sparsity prior, built by ``fit(..., optimise=False)`` as the UCI script
builds it before ``optimise``."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import data
from benchmark.models import dtype, join, leaves, split  # noqa: F401  (the kind's)


def inputs(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The stand-in data set of ``num_data`` rows from the seed, and one
    fold's training rows (``train_rows`` of a seeded permutation)."""
    X, y = data.synth_pumadyn(cfg["num_data"], cfg["num_dims"], data.rng(seed, 0))
    rows = data.rng(seed, 1).permutation(cfg["num_data"])[: cfg["train_rows"]]
    return {"X": X[rows], "Y": y[rows]}


def build(cfg: dict, inp: Dict[str, np.ndarray], device: torch.device):
    """The fitted-but-not-optimised ``oak_model``."""
    from oak_tpu_torch import oak_model

    oak = oak_model(max_interaction_depth=cfg["max_interaction_depth"],
                    num_inducing=cfg["num_inducing"],
                    lengthscale_bounds=cfg["lengthscale_bounds"],
                    use_sparsity_prior=cfg["use_sparsity_prior"],
                    use_normalising_flow=cfg["use_normalising_flow"],
                    share_var_across_orders=cfg["share_var_across_orders"],
                    likelihood=cfg["likelihood"], optimizer=cfg["optimizer"],
                    dtype=dtype(cfg), device=device)
    return oak.fit(inp["X"].astype(np.float64), inp["Y"].astype(np.float64),
                   optimise=False)


def state(oak) -> Dict[str, np.ndarray]:
    """What the program's set-up made that the reference takes as given:
    each flow's parameters ([D] each) and the inducing points."""
    flows = oak.input_flows
    return {
        "skewness": np.array([float(f.skewness.value.detach()) for f in flows]),
        "tailweight": np.array([float(f.tailweight.value.detach()) for f in flows]),
        "scale": np.array([float(f.scale.value.detach()) for f in flows]),
        "shift": np.array([float(f.shift.value.detach()) for f in flows]),
        "offset": np.array([float(f.offset) for f in flows]),
        "Z": oak.m.Z.value.detach().double().cpu().numpy(),
    }
