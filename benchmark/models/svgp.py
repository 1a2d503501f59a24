"""The bench's SVGP (``bench.py::_build_model``'s pattern): pumadyn-shaped
data from the seed, inducing points drawn from its rows, a whitened SVGP
with a diagonal q(u) and a Gaussian likelihood over the OAK kernel."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import data
from benchmark.models import dtype, join, leaves, split  # noqa: F401  (the kind's)


def inputs(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    N, D, M = cfg["num_data"], cfg["num_dims"], cfg["num_inducing"]
    X, y = data.synth_pumadyn(N, D, data.rng(seed, 0))
    Z = X[data.rng(seed, 1).choice(N, M, replace=False)]
    return {"X": X, "Y": y, "Z": Z}


def build(cfg: dict, inp: Dict[str, np.ndarray], device: torch.device):
    from oak_tpu_torch import SVGP, Gaussian, OAKKernel

    kw = dict(dtype=dtype(cfg), device=device)
    kernel = OAKKernel.create(num_dims=cfg["num_dims"],
                              max_interaction_depth=cfg["max_interaction_depth"],
                              use_sparsity_prior=cfg["use_sparsity_prior"],
                              lengthscale_bounds=cfg["lengthscale_bounds"], **kw)
    lik = Gaussian.create(cfg["noise_variance"], **kw)
    return SVGP.create(kernel, lik, inp["Z"], num_data=cfg["num_data"],
                       q_diag=cfg["q_diag"], whiten=cfg["whiten"])
