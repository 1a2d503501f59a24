"""The reference's UCI classification setting through the port's
``oak_model``: continuous, binary and categorical columns, flows on the
continuous ones, the labels left in {0, 1}, inducing points by level
frequency on the discrete columns and k-means on the continuous block, and
the Bernoulli SVGP (whitened, a diagonal q) over the OAK kernel with shared
variances across orders and the sparsity prior, built by ``fit(...,
optimise=False)`` as the classification script builds it before
``optimise``.

The trainable leaves are named as ``reference/svgp_bernoulli.py`` names
them: ``lengthscale.<d>`` of each continuous dim d, ``variance.<n>`` of each
order, ``W.<d>`` and ``kappa.<d>`` of each categorical dim d, ``q_mu`` and
``q_sqrt``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from benchmark import data
from benchmark.models import dtype  # noqa: F401  (the kind's)

_LEAF = [(re.compile(r"kernel\.kernels\.(\d+)\.lengthscale\.raw"), "lengthscale.{}"),
         (re.compile(r"kernel\.kernels\.(\d+)\.W\.raw"), "W.{}"),
         (re.compile(r"kernel\.kernels\.(\d+)\.kappa\.raw"), "kappa.{}"),
         (re.compile(r"kernel\.variances\.(\d+)\.raw"), "variance.{}"),
         (re.compile(r"q_mu\.raw"), "q_mu"),
         (re.compile(r"q_sqrt\.raw"), "q_sqrt")]

# (mean, standard deviation) of heart's continuous columns (age, trestbps,
# chol, thalach, oldpeak) as the stand-in draws them; oldpeak is drawn
# exponential with that mean, chol log-normal
_CONTINUOUS = [(54.4, 9.0), (131.7, 17.6), (247.4, 52.0), (149.6, 22.9), (1.05, 1.05)]
# the seed of the stand-in's law: its binary shares, level frequencies and
# effects, the same in every run
_LAW = 20220607


def _columns(cfg: dict):
    binary, categorical = list(cfg["binary_feature"]), list(cfg["categorical_feature"])
    continuous = [d for d in range(cfg["num_dims"]) if d not in binary + categorical]
    return continuous, binary, categorical


def inputs(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The stand-in data set of ``num_data`` rows with the configuration's
    column types, and one fold's training rows (``train_rows`` of a seeded
    permutation): binary columns Bernoulli draws, categorical columns codes
    0..C-1 with uneven level frequencies, continuous columns with heart's
    scales and skews, and labels from a logit with main effects of every
    column and one continuous-by-binary interaction. Every level of every
    discrete column is present in the training rows.

    The law is one data set's, as the deployment has one: the binary
    shares, level frequencies and effects are one fixed draw (``_LAW``),
    and the seed draws the rows and labels from it."""
    gen, law = data.rng(seed, 0), np.random.default_rng(_LAW)
    n = cfg["num_data"]
    continuous, binary, categorical = _columns(cfg)
    X = np.zeros((n, cfg["num_dims"]))
    logits = np.zeros(n)
    for k, d in enumerate(continuous):
        mean, sd = _CONTINUOUS[k % len(_CONTINUOUS)]
        if k % len(_CONTINUOUS) == 4:
            X[:, d] = gen.exponential(mean, size=n)
        elif k % len(_CONTINUOUS) == 2:
            s2 = np.log1p((sd / mean) ** 2)
            X[:, d] = gen.lognormal(np.log(mean) - s2 / 2, np.sqrt(s2), size=n)
        else:
            X[:, d] = gen.normal(mean, sd, size=n)
        logits += law.normal() / np.sqrt(len(continuous)) * (X[:, d] - mean) / sd
    for d in binary:
        p = law.uniform(0.25, 0.75)
        X[:, d] = gen.uniform(size=n) < p
        logits += law.normal() * (X[:, d] - p)
    for d in categorical:
        C = cfg["categorical_levels"][str(d)]
        probs = law.dirichlet(np.full(C, 3.0))
        X[:, d] = gen.choice(C, size=n, p=probs)
        effects = law.normal(size=C)
        logits += effects[X[:, d].astype(int)] - probs @ effects
    if continuous and binary:
        c = continuous[0]
        logits += 0.8 * (X[:, c] - X[:, c].mean()) / X[:, c].std() * (X[:, binary[0]] - 0.5)
    y = (gen.uniform(size=n) < 1.0 / (1.0 + np.exp(-2.5 * logits))).astype(np.float64)
    rows = data.rng(seed, 1).permutation(n)[: cfg["train_rows"]]
    X, y = X[rows], y[rows]
    for d in binary + categorical:
        levels = 2 if d in binary else cfg["categorical_levels"][str(d)]
        for level in range(levels):
            if not (X[:, d] == level).any():
                X[level, d] = level
    return {"X": X, "Y": y}


def build(cfg: dict, inp: Dict[str, np.ndarray], device: torch.device):
    """The fitted-but-not-optimised ``oak_model``."""
    from oak_tpu_torch import oak_model

    oak = oak_model(max_interaction_depth=cfg["max_interaction_depth"],
                    num_inducing=cfg["num_inducing"],
                    lengthscale_bounds=cfg["lengthscale_bounds"],
                    binary_feature=list(cfg["binary_feature"]),
                    categorical_feature=list(cfg["categorical_feature"]),
                    use_sparsity_prior=cfg["use_sparsity_prior"],
                    use_normalising_flow=cfg["use_normalising_flow"],
                    share_var_across_orders=cfg["share_var_across_orders"],
                    likelihood=cfg["likelihood"], optimizer=cfg["optimizer"],
                    dtype=dtype(cfg), device=device)
    return oak.fit(inp["X"], inp["Y"], optimise=False)


def state(oak) -> Dict[str, np.ndarray]:
    """What the program's set-up made that the reference takes as given:
    the continuous columns' flow parameters ([Dc] each, in column order) and
    the inducing points."""
    flows = [oak.input_flows[d] for d in oak.continuous_index]
    return {
        "skewness": np.array([float(f.skewness.value.detach()) for f in flows]),
        "tailweight": np.array([float(f.tailweight.value.detach()) for f in flows]),
        "scale": np.array([float(f.scale.value.detach()) for f in flows]),
        "shift": np.array([float(f.shift.value.detach()) for f in flows]),
        "offset": np.array([float(f.offset) for f in flows]),
        "Z": oak.m.Z.value.detach().double().cpu().numpy(),
    }


def leaves(model, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The trainable vector ``vec`` [n] cut into the model's leaves, in the
    program's order, named as the reference names them."""
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
    """The reference's leaves at the program's grain: one per order's
    variance, the others flat."""
    out = {}
    for k, v in ref.items():
        if k == "variance":
            out.update({f"variance.{i}": v[i].reshape(1).cpu() for i in range(v.shape[0])})
        else:
            out[k] = v.reshape(-1).cpu()
    return out


def join(leaves_: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``split``'s inverse, shaped and placed as ``like``."""
    out = {}
    for k, v in like.items():
        if k == "variance":
            out[k] = torch.cat([leaves_[f"variance.{i}"] for i in range(v.shape[0])]).to(v)
        else:
            out[k] = leaves_[k].reshape(v.shape).to(v)
    return out
