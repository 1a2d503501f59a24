"""The training loss of a whitened sparse variational GP with a diagonal
q(u) and a Bernoulli likelihood (Hensman, Matthews and Ghahramani 2015),
over the OAK kernel of continuous, binary and categorical dims
(``discrete``), with the Gamma(1, 0.2) sparsity prior on the order
variances: the reference's classification model.

    Luu = chol(Kuu + j I),  A = Luu^-1 Kuf
    f_mean = A^T m,  f_var = diag Kff - colsum(A^2) + (A^2)^T s^2
    E_q[log p(y | f)] = sum_k w_k log p(y | f_mean + sqrt(2 f_var) x_k) / sqrt(pi)
    p(y = 1 | f) = sigmoid(f) (1 - 2 jit) + jit
    ELBO = sum_rows E_q[log p(y | f)] - KL(N(m, diag s^2) || N(0, I))
    loss = -(ELBO + sum_n log Gamma(sigma2_n; 1, 0.2))

with (x_k, w_k) numpy's ``hermgauss`` (physicists' Gauss-Hermite) of
``num_gh`` points and the link's jitter ``link_jitter``. The discrete dims'
measures are taken from the rows X (``discrete.measures``).

Leaves, unconstrained: ``lengthscale.<d>`` [1] for each continuous dim d
(sigmoid onto the bounds), ``variance`` [P + 1] (softplus), ``W.<d>``
[C * rank] (identity) and ``kappa.<d>`` [C] (softplus) for each categorical
dim d, ``q_mu`` [M], ``q_sqrt`` [M] (softplus). The binary and categorical
base variances are 1 (shared across orders) and not leaves.

Departures: the program floors f_var at 1e-10 in float32 (1e-30 in
float64) before its square root; here at 1e-30 in either dtype. The
program's quadrature is the probabilists' form of the same rule.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import discrete, oak
from .oak import F64, Precision


def dims(cfg: dict):
    """(continuous, binary, categorical) dims of the configuration."""
    binary, categorical = list(cfg["binary_feature"]), list(cfg["categorical_feature"])
    continuous = [d for d in range(cfg["num_dims"]) if d not in binary + categorical]
    return continuous, binary, categorical


def inducing(cfg: dict) -> int:
    return min(cfg["num_inducing"], cfg["train_rows"])


def initial_leaves(cfg: dict, precision: Precision = F64, device=None) -> Dict[str, torch.Tensor]:
    """The unconstrained values of the model as the configuration builds it:
    each categorical W drawn U[0, 1) from a generator seeded with its dim,
    in the configuration's dtype."""
    kw = dict(dtype=precision.dtype, device=device)
    low, high = cfg["lengthscale_bounds"]
    continuous, _, categorical = dims(cfg)
    M, P = inducing(cfg), cfg["max_interaction_depth"]
    out = {f"lengthscale.{d}": torch.full((1,), oak.inv_sigmoid_bounded(1.0, low, high), **kw)
           for d in continuous}
    out["variance"] = torch.full((P + 1,), oak.inv_softplus(1.0), **kw)
    for d in categorical:
        C = cfg["categorical_levels"][str(d)]
        W = torch.rand((C, cfg["categorical_rank"]), generator=torch.Generator().manual_seed(d),
                       dtype=getattr(torch, cfg["dtype"]))
        out[f"W.{d}"] = W.reshape(-1).to(**kw)
        out[f"kappa.{d}"] = torch.full((C,), oak.inv_softplus(1.0), **kw)
    out["q_mu"] = torch.zeros((M,), **kw)
    out["q_sqrt"] = torch.full((M,), oak.inv_softplus(1.0), **kw)
    return out


def _kernel(cfg: dict, X: torch.Tensor, leaves: Dict[str, torch.Tensor]):
    """(lengthscales by dim, tables by dim, order variances)."""
    low, high = cfg["lengthscale_bounds"]
    continuous, binary, categorical = dims(cfg)
    ls = {d: oak.sigmoid_bounded(leaves[f"lengthscale.{d}"][0], low, high) for d in continuous}
    p = discrete.measures(X, binary, categorical)
    B = discrete.tables(leaves, oak.softplus, binary, categorical, p)
    return ls, B, oak.softplus(leaves["variance"])


def gram(cfg: dict, X: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
         leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The OAK gram between the rows A and B_, the measures from X."""
    ls, B, sig2 = _kernel(cfg, X, leaves)
    return discrete.combine(discrete.dim_grams(A, B_, ls, B), sig2)


def log_lik(cfg: dict, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    j = cfg["link_jitter"]
    prob = torch.sigmoid(f) * (1.0 - 2.0 * j) + j
    return y * torch.log(prob) + (1.0 - y) * torch.log(1.0 - prob)


def loss(cfg: dict, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
         leaves: Dict[str, torch.Tensor], precision: Precision = F64) -> torch.Tensor:
    """The loss at ``leaves`` for rows X [N, D] (continuous columns as the
    model sees them, discrete columns as codes), labels Y [N] in {0, 1},
    inducing points Z [M, D], in the precision's dtype."""
    ls, B, sig2 = _kernel(cfg, X, leaves)
    q_mu, q_sqrt = leaves["q_mu"], oak.softplus(leaves["q_sqrt"])
    Kuu = discrete.combine(discrete.dim_grams(Z, Z, ls, B), sig2)
    L = torch.linalg.cholesky(oak.jittered(Kuu, cfg["jitter"], relative=True))
    Kuf = discrete.combine(discrete.dim_grams(Z, X, ls, B), sig2)
    A = precision.mm(oak.lower_inverse(L), Kuf)  # [M, N]
    A2 = A * A
    fmu = precision.mm(q_mu[None, :], A)[0]
    fvar = (discrete.combine(discrete.dim_diags(X, ls, B), sig2) - A2.sum(0)
            + precision.mm((q_sqrt * q_sqrt)[None, :], A2)[0])
    x, w = np.polynomial.hermite.hermgauss(cfg["num_gh"])
    x = torch.as_tensor(x, dtype=A.dtype, device=A.device)
    w = torch.as_tensor(w / math.sqrt(math.pi), dtype=A.dtype, device=A.device)
    f = fmu[:, None] + torch.sqrt(2.0 * torch.clamp_min(fvar, 1e-30))[:, None] * x
    ve = (log_lik(cfg, f, Y[:, None]) * w).sum()
    M = q_mu.shape[0]
    kl = 0.5 * (torch.sum(q_sqrt ** 2) + torch.sum(q_mu ** 2) - M
                - 2.0 * torch.sum(torch.log(q_sqrt)))
    prior = oak.gamma_log_prob(sig2, *cfg["order_variance_prior"]).sum()
    return -(ve - kl + prior)
