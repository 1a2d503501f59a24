"""Sparse variational GP, whitened or not, q_diag or full q_sqrt
(``oak_tpu.models.svgp.SVGP``), with a Gaussian or Bernoulli likelihood.

On a float32 CUDA input the OAK gram runs through the fused CUDA kernels,
forward and backward, so ``elbo`` and ``training_loss`` differentiate on the
card (``ops.oak_gram.FusedGram``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import like
from ..kernels.oak_kernel import OAKKernel
from ..ops.psd import (cholesky, cholesky_solve, safe_cholesky, solve_lower,
                       solve_upper, tri_inv_lower)
from ..params import Param, fixed, log_prior_density, param, positive
from ..utils.profiling import spanned


class SVGP(nn.Module):
    _fields = ("kernel", "likelihood", "Z", "q_mu", "q_sqrt")

    def __init__(self, kernel: OAKKernel, likelihood: nn.Module, Z: Param,
                 q_mu: Param, q_sqrt: Param, q_diag: bool = True,
                 whiten: bool = True, num_data: Optional[int] = None):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.Z = Z  # [M, D]
        self.q_mu = q_mu  # [M, R]
        self.q_sqrt = q_sqrt  # diag: [M, R] positive; full: [R, M, M] lower
        self.q_diag = q_diag
        self.whiten = whiten
        self.num_data = num_data

    @classmethod
    def create(cls, kernel: OAKKernel, likelihood: nn.Module, Z,
               num_latent: int = 1, q_diag: bool = True, whiten: bool = True,
               trainable_Z: bool = False, num_data: Optional[int] = None,
               dtype: Optional[torch.dtype] = None, device=None) -> "SVGP":
        """Built in ``kernel``'s dtype and device unless told otherwise."""
        dtype, device = like(kernel, dtype, device)
        kw = dict(dtype=dtype, device=device)
        Z = torch.as_tensor(Z, **kw)
        M = Z.shape[0]
        Zp = param(Z, **kw) if trainable_Z else fixed(Z, **kw)
        q_mu = param(torch.zeros((M, num_latent), **kw), **kw)
        if q_diag:
            q_sqrt = positive(torch.ones((M, num_latent), **kw), **kw)
        else:
            eye = torch.eye(M, **kw)
            q_sqrt = param(eye[None].repeat(num_latent, 1, 1), **kw)
        return cls(kernel, likelihood, Zp, q_mu, q_sqrt, q_diag=q_diag,
                   whiten=whiten, num_data=num_data)

    # ------------------------------------------------------------------ #
    def _q_sqrt_mats(self) -> torch.Tensor:
        """[R, M, M] lower-triangular scale of q(u)."""
        q = self.q_sqrt.value
        if self.q_diag:
            return torch.diag_embed(q.T)
        return torch.tril(q)

    def prior_kl(self) -> torch.Tensor:
        """KL(q(u) || p(u)); whitened p(u) = N(0, I), else through Luu."""
        q_mu = self.q_mu.value
        M, R = q_mu.shape
        if self.q_diag:
            q = self.q_sqrt.value  # [M, R] standard deviations
            logdet = 2.0 * torch.sum(torch.log(q))
            trace = torch.sum(q * q)
        else:
            Lq = torch.tril(self.q_sqrt.value)
            diag = torch.diagonal(Lq, dim1=-2, dim2=-1)
            logdet = 2.0 * torch.sum(torch.log(torch.abs(diag)))
            trace = torch.sum(Lq * Lq)
        if self.whiten:
            mahal = torch.sum(q_mu * q_mu)
            return 0.5 * (trace + mahal - M * R - logdet)
        Luu = cholesky(self.kernel.K(self.Z.value))
        alpha = solve_lower(Luu, q_mu)
        mahal = torch.sum(alpha * alpha)
        LinvLq = solve_lower(Luu, self._q_sqrt_mats())
        trace_w = torch.sum(LinvLq * LinvLq)
        logdet_p = 2.0 * R * torch.sum(torch.log(torch.diagonal(Luu)))
        return 0.5 * (trace_w + mahal - M * R - logdet + logdet_p)

    # ------------------------------------------------------------------ #
    def _safe_Luu(self) -> torch.Tensor:
        """Jitter-escalated Cholesky of Kuu for the prediction paths: a
        trained OAK can sit at near-constant per-dim kernels where Kuu is on
        the edge of f32 conditioning; escalation keeps predictions finite."""
        L, _ = safe_cholesky(self.kernel.K(self.Z.value))
        return L

    def predict_factors(self, safe: bool = True) -> Dict[str, torch.Tensor]:
        """What ``predict_f`` needs that does not depend on Xnew: Z, Kuu's
        Cholesky factor (jitter-escalated unless ``safe=False``, the ELBO's
        single-jitter factor), q_mu and q_sqrt's value."""
        Z = self.Z.value
        return {"Z": Z, "Luu": self._safe_Luu() if safe else cholesky(self.kernel.K(Z)),
                "q_mu": self.q_mu.value, "q_sqrt": self.q_sqrt.value}

    def predict_f_from(self, factors: Dict[str, torch.Tensor], Xnew: torch.Tensor,
                       full_cov: bool = False, kernel=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``predict_f`` on ``predict_factors``: Kus, K_diag and triangular
        solves, with no host synchronisation (``serving`` traces it).

        ``kernel``, if given, takes the model kernel's place in K and K_diag:
        the posterior of one additive component (``plotting``)."""
        k = self.kernel if kernel is None else kernel
        Luu, q_mu, q_sqrt = factors["Luu"], factors["q_mu"], factors["q_sqrt"]
        Kus = k.K(factors["Z"], Xnew)  # [M, S]
        R = q_mu.shape[1]
        A = solve_lower(Luu, Kus)  # Luu⁻¹ Kus
        W = A if self.whiten else solve_upper(Luu, A)  # Kuu⁻¹ Kus unwhitened

        mean = W.T @ q_mu  # [S, R]
        if self.q_diag:
            SW2 = (W * W).T @ (q_sqrt * q_sqrt)  # [S, R]; q_sqrt [M, R]
        else:
            LqTW = torch.tril(q_sqrt).mT @ W  # [R, M, S]
            SW2 = torch.sum(LqTW * LqTW, dim=1).T  # [S, R]

        if full_cov:
            base = k.K(Xnew) - A.T @ A
            if self.q_diag:
                covs = torch.stack([
                    base + (W * (q_sqrt[:, r] ** 2)[:, None]).T @ W for r in range(R)])
            else:
                Lq = torch.tril(q_sqrt)
                covs = torch.stack([
                    base + (Lq[r].T @ W).T @ (Lq[r].T @ W) for r in range(R)])
            return mean, covs
        var = (k.K_diag(Xnew) - torch.sum(A * A, dim=0))[:, None] + SW2
        return mean, var

    def predict_f(self, Xnew: torch.Tensor, full_cov: bool = False,
                  safe: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive mean [S, R] and variance [S, R] (or covariance
        [R, S, S] with ``full_cov``). ``safe=False`` (the ELBO's call) uses
        the single-jitter Cholesky. Both solves are triangular solves
        against Kus, whatever its width."""
        return self.predict_f_from(self.predict_factors(safe), Xnew, full_cov)

    def predict_y(self, Xnew: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, var = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(mu, var)

    def predict_log_density(self, Xnew: torch.Tensor, Ynew: torch.Tensor) -> torch.Tensor:
        mu, var = self.predict_f(Xnew)
        if Ynew.dim() == 1:
            Ynew = Ynew[:, None]
        return torch.sum(self.likelihood.predict_log_density(mu, var, Ynew), dim=-1)

    # ------------------------------------------------------------------ #
    def elbo_terms(self, X: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor]:
        """The ELBO's sum over the rows of (X, Y): the variational
        expectations' total, as a 1-tuple. The shards of a data-sharded
        batch add their terms (``parallel``)."""
        if Y.dim() == 1:
            Y = Y[:, None]
        fmu, fvar = self.predict_f(X, safe=False)
        return (torch.sum(self.likelihood.variational_expectations(fmu, fvar, Y)),)

    def elbo_from_terms(self, terms, num_rows: int) -> torch.Tensor:
        """The ELBO from ``elbo_terms`` summed over a batch of ``num_rows``
        rows, the global batch when it is sharded: the expectations scaled
        to ``num_data``, less the KL."""
        scale = 1.0 if self.num_data is None else self.num_data / num_rows
        return terms[0] * scale - self.prior_kl()

    def elbo(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self.elbo_from_terms(self.elbo_terms(X, Y), X.shape[0])

    @spanned("oak.bound")
    def training_loss_from_terms(self, terms, num_rows: int) -> torch.Tensor:
        return -(self.elbo_from_terms(terms, num_rows) + log_prior_density(self))

    @spanned("oak.bound")
    def training_loss(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self.training_loss_from_terms(self.elbo_terms(X, Y), X.shape[0])

    def predict_f_samples(self, Xnew: torch.Tensor, num_samples: int = 1,
                          generator_or_seed=0) -> torch.Tensor:
        """Joint posterior draws at Xnew, [num_samples, S, R]
        (``models.sampling``)."""
        from .sampling import predict_f_samples

        return predict_f_samples(self, Xnew, num_samples, generator_or_seed)

    # ------------------------------------------------------------------ #
    def posterior_alpha(self) -> torch.Tensor:
        """alpha [M, R] with predictive mean = K(Xnew, Z) alpha, through the
        same escalated factor as ``predict_f``."""
        Luu = self._safe_Luu()
        if self.whiten:
            return solve_upper(Luu, self.q_mu.value)
        return cholesky_solve(Luu, self.q_mu.value)

    def posterior_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha, Qinv): predictive mean = Kxu alpha, covariance = Kxx -
        Kxu Qinv Kux, for the first latent. Whitened: alpha = Luu⁻ᵀ q_mu,
        Qinv = Luu⁻ᵀ (I - S) Luu⁻¹ with S = Lq Lqᵀ."""
        Luu = self._safe_Luu()
        Lq = self._q_sqrt_mats()[0]
        S = Lq @ Lq.T
        Linv = tri_inv_lower(Luu)
        if self.whiten:
            eye = torch.eye(Luu.shape[0], dtype=Luu.dtype, device=Luu.device)
            return solve_upper(Luu, self.q_mu.value), Linv.T @ (eye - S) @ Linv
        Kuu_inv = Linv.T @ Linv
        return Kuu_inv @ self.q_mu.value, Kuu_inv - Kuu_inv @ S @ Kuu_inv

    @property
    def inducing_points(self) -> torch.Tensor:
        return self.Z.value
