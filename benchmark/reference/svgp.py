"""The training loss of a whitened sparse variational GP (Hensman et al.
2015) with a diagonal q(u) and a Gaussian likelihood, over the OAK kernel,
with the Gamma(1, 0.2) sparsity prior on the order variances.

    Luu = chol(Kuu + j I),  A = Luu^-1 Kuf
    f_mean = A^T m,  f_var = diag Kff - colsum(A^2) + (A^2)^T s^2
    ELBO = (N / n) sum_rows E_q[log N(y | f, sigma2)] - KL(N(m, diag s^2) || N(0, I))
    loss = -(ELBO + sum_n log Gamma(sigma2_n; 1, 0.2))

Leaves, unconstrained: ``lengthscale`` [D] (sigmoid onto the bounds),
``variance`` [P + 1], ``noise`` (softplus, plus its floor), ``q_mu`` [M],
``q_sqrt`` [M] (softplus).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import oak
from .oak import F64, Precision

LOG2PI = math.log(2.0 * math.pi)


def initial_leaves(cfg: dict, M: int, precision: Precision = F64, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The unconstrained values of the model as the configuration builds it."""
    kw = dict(dtype=precision.dtype, device=device)
    low, high = cfg["lengthscale_bounds"]
    D, P = cfg["num_dims"], cfg["max_interaction_depth"]
    return {
        "lengthscale": torch.full((D,), oak.inv_sigmoid_bounded(1.0, low, high), **kw),
        "variance": torch.full((P + 1,), oak.inv_softplus(1.0), **kw),
        "noise": torch.tensor(oak.inv_softplus(cfg["noise_variance"] - cfg["noise_floor"]), **kw),
        "q_mu": torch.zeros((M,), **kw),
        "q_sqrt": torch.full((M,), oak.inv_softplus(1.0), **kw),
    }


def constrained(cfg: dict, leaves: Dict[str, torch.Tensor]):
    low, high = cfg["lengthscale_bounds"]
    return (oak.sigmoid_bounded(leaves["lengthscale"], low, high),
            oak.softplus(leaves["variance"]),
            oak.softplus(leaves["noise"]) + cfg["noise_floor"],
            leaves["q_mu"], oak.softplus(leaves["q_sqrt"]))


def loss(cfg: dict, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
         leaves: Dict[str, torch.Tensor], precision: Precision = F64,
         num_data: int = None) -> torch.Tensor:
    """The negative ELBO less the log prior at ``leaves``; X [n, D], Y [n],
    Z [M, D] in the precision's dtype; ``num_data`` N (default n)."""
    ls, sig2, noise, q_mu, q_sqrt = constrained(cfg, leaves)
    n = X.shape[0]
    N = n if num_data is None else num_data
    Kuu = oak.oak_gram(Z, Z, ls, sig2)
    L = torch.linalg.cholesky(oak.jittered(Kuu, cfg["jitter"], relative=True))
    A = precision.mm(oak.lower_inverse(L), oak.oak_gram(Z, X, ls, sig2))  # [M, n]
    A2 = A * A
    fmu = precision.mm(q_mu[None, :], A)[0]
    fvar = oak.oak_diag(X, ls, sig2) - A2.sum(0) + precision.mm((q_sqrt * q_sqrt)[None, :], A2)[0]
    ve = -0.5 * (LOG2PI + torch.log(noise) + ((Y - fmu) ** 2 + fvar) / noise)
    M = q_mu.shape[0]
    kl = 0.5 * (torch.sum(q_sqrt ** 2) + torch.sum(q_mu ** 2) - M
                - 2.0 * torch.sum(torch.log(q_sqrt)))
    elbo = ve.sum() * (N / n) - kl
    prior = oak.gamma_log_prob(sig2, *cfg["order_variance_prior"]).sum()
    return -(elbo + prior)
