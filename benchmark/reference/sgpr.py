"""The training loss of sparse GP regression by Titsias's (2009) collapsed
bound, over the OAK kernel, with the Gamma(1, 0.2) sparsity prior on the
order variances:

    L = chol(Kuu + j I),  A = L^-1 Kuf / sigma,  B = I + A A^T,  LB = chol(B)
    c = LB^-1 A y / sigma
    bound = -N/2 log 2 pi - sum log diag LB - N/2 log sigma2 - y^T y / (2 sigma2)
            + |c|^2 / 2 - (sum diag Kff / sigma2 - tr(A A^T)) / 2
    loss = -(bound + sum_n log Gamma(sigma2_n; 1, 0.2))

Leaves, unconstrained: ``lengthscale`` [D] (sigmoid onto the bounds),
``variance`` [P + 1] and ``noise`` (softplus, the noise plus its floor).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import oak
from .oak import F64, Precision

LOG2PI = math.log(2.0 * math.pi)


def initial_leaves(cfg: dict, precision: Precision = F64, device=None) -> Dict[str, torch.Tensor]:
    kw = dict(dtype=precision.dtype, device=device)
    low, high = cfg["lengthscale_bounds"]
    D, P = cfg["num_dims"], cfg["max_interaction_depth"]
    return {
        "lengthscale": torch.full((D,), oak.inv_sigmoid_bounded(1.0, low, high), **kw),
        "variance": torch.full((P + 1,), oak.inv_softplus(1.0), **kw),
        "noise": torch.tensor(oak.inv_softplus(cfg["noise_variance"] - cfg["noise_floor"]), **kw),
    }


def loss(cfg: dict, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
         leaves: Dict[str, torch.Tensor], precision: Precision = F64) -> torch.Tensor:
    """The loss at ``leaves`` for rows X [N, D], targets Y [N], inducing
    points Z [M, D], in the precision's dtype."""
    low, high = cfg["lengthscale_bounds"]
    ls = oak.sigmoid_bounded(leaves["lengthscale"], low, high)
    sig2 = oak.softplus(leaves["variance"])
    noise = oak.softplus(leaves["noise"]) + cfg["noise_floor"]
    sigma = torch.sqrt(noise)
    N, M = X.shape[0], Z.shape[0]
    L = torch.linalg.cholesky(oak.jittered(oak.oak_gram(Z, Z, ls, sig2), cfg["jitter"],
                                           relative=True))
    A = precision.mm(oak.lower_inverse(L), oak.oak_gram(Z, X, ls, sig2)) / sigma
    AAT = precision.mm(A, A.T)
    LB = torch.linalg.cholesky(AAT + torch.eye(M, dtype=A.dtype, device=A.device))
    c = precision.mm(oak.lower_inverse(LB), precision.mm(A, Y[:, None]))[:, 0] / sigma
    bound = (-0.5 * N * LOG2PI - torch.sum(torch.log(torch.diagonal(LB)))
             - 0.5 * N * torch.log(noise) - 0.5 * torch.sum(Y * Y) / noise
             + 0.5 * torch.sum(c * c)
             - 0.5 * (torch.sum(oak.oak_diag(X, ls, sig2)) / noise - torch.trace(AAT)))
    prior = oak.gamma_log_prob(sig2, *cfg["order_variance_prior"]).sum()
    return -(bound + prior)

