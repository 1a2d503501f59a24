"""Exact GP regression with the OAK kernel (``oak_tpu.models.gpr.GPR``).

The data are buffers ``X`` [N, D] and ``Y`` [N, R], at the key paths
``.X`` and ``.Y`` of ``oak_tpu``'s keypath npz. On a float32 CUDA input the
square gram K(X) runs through the fused CUDA kernels, forward and backward.

``oak_tpu`` refines its factor and solves against bf16 inside XLA:TPU's
solvers; the port's float32 runs in full precision, so the prediction
paths use the training path's Cholesky and plain triangular solves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import like
from ..kernels.oak_kernel import OAKKernel
from ..ops.psd import cholesky, cholesky_solve, logdet_from_chol, solve_lower
from ..params import log_prior_density
from .likelihoods import Gaussian

_LOG2PI = math.log(2.0 * math.pi)


def as_data(X, Y, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X [N, D], Y [N, R]) as tensors of ``dtype`` on ``device``; a 1-D Y
    becomes one column."""
    X = torch.as_tensor(X, dtype=dtype, device=device)
    Y = torch.as_tensor(Y, dtype=dtype, device=device)
    return X, Y[:, None] if Y.dim() == 1 else Y


class GPR(nn.Module):
    _fields = ("kernel", "likelihood", "X", "Y")

    def __init__(self, kernel: OAKKernel, likelihood: Gaussian, X: torch.Tensor,
                 Y: torch.Tensor):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.register_buffer("X", X)
        self.register_buffer("Y", Y)

    @classmethod
    def create(cls, X, Y, kernel: OAKKernel, noise_variance: float = 1.0,
               dtype: Optional[torch.dtype] = None, device=None) -> "GPR":
        """Built in ``kernel``'s dtype and device unless told otherwise."""
        dtype, device = like(kernel, dtype, device)
        X, Y = as_data(X, Y, dtype, device)
        return cls(kernel, Gaussian.create(noise_variance, dtype=dtype, device=device),
                   X, Y)

    # ------------------------------------------------------------------ #
    def _chol(self) -> torch.Tensor:
        """Cholesky factor of K(X) + σ² I, no jitter beyond the noise."""
        K = self.kernel.K(self.X)
        Ky = K + self.likelihood.variance.value * torch.eye(
            K.shape[0], dtype=K.dtype, device=K.device)
        return cholesky(Ky, jitter=0.0)

    def log_marginal_likelihood(self) -> torch.Tensor:
        L = self._chol()
        N, R = self.Y.shape
        alpha = cholesky_solve(L, self.Y)
        # yᵀ K⁻¹ y >= 0 in exact arithmetic: enforced, so that a factor broken
        # by f32 cannot fabricate likelihood (as the SGPR bound's clamps)
        quad = torch.clamp_min(torch.sum(self.Y * alpha), 0.0)
        return -0.5 * (quad + R * logdet_from_chol(L) + N * R * _LOG2PI)

    def training_loss(self) -> torch.Tensor:
        """-(log marginal likelihood + log priors)."""
        return -(self.log_marginal_likelihood() + log_prior_density(self))

    # ------------------------------------------------------------------ #
    def predict_f(self, Xnew: torch.Tensor, full_cov: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean [S, R] and variance [S, R], or covariance [S, S] shared by
        the R outputs with ``full_cov``; triangular solves against the N × N
        factor."""
        L = self._chol()
        A = solve_lower(L, self.kernel.K(self.X, Xnew))  # [N, S]
        mean = A.T @ solve_lower(L, self.Y)
        if full_cov:
            return mean, self.kernel.K(Xnew) - A.T @ A
        var = self.kernel.K_diag(Xnew) - torch.sum(A * A, dim=0)
        return mean, var[:, None].repeat(1, self.Y.shape[1])

    def predict_f_samples(self, Xnew: torch.Tensor, num_samples: int = 1,
                          generator_or_seed=0) -> torch.Tensor:
        """Joint posterior draws at Xnew, [num_samples, S, R]."""
        from .sampling import predict_f_samples

        return predict_f_samples(self, Xnew, num_samples, generator_or_seed)

    def predict_y(self, Xnew: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, var = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(mu, var)

    def predict_log_density(self, Xnew: torch.Tensor, Ynew: torch.Tensor) -> torch.Tensor:
        mu, var = self.predict_f(Xnew)
        if Ynew.dim() == 1:
            Ynew = Ynew[:, None]
        return torch.sum(self.likelihood.predict_log_density(mu, var, Ynew), dim=-1)

    # ------------------------------------------------------------------ #
    def posterior_alpha(self) -> torch.Tensor:
        """alpha = (K + σ² I)⁻¹ Y, with predictive mean = K(Xnew, X) alpha."""
        return cholesky_solve(self._chol(), self.Y)

    def posterior_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha, Qinv): predictive mean = K(Xnew, X) alpha, covariance =
        K(Xnew) - K(Xnew, X) Qinv K(X, Xnew), Qinv = (K + σ² I)⁻¹."""
        L = self._chol()
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        return cholesky_solve(L, self.Y), cholesky_solve(L, eye)

    @property
    def data(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.X, self.Y

    @property
    def inducing_points(self) -> Optional[torch.Tensor]:
        return None
