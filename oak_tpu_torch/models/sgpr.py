"""Sparse GP regression, the Titsias (2009) collapsed bound
(``oak_tpu.models.sgpr.SGPR``).

Fields in ``oak_tpu``'s order: kernel, likelihood, the inducing inputs Z (a
Param, fixed by default), and the data buffers X, Y. On a float32 CUDA input
Kuu and Kuf run through the fused CUDA kernels, forward and backward, and the
bound's L⁻¹Kuf (``elbo_terms``) through the triangular-solve kernel
(``ops.psd.solve_lower_wide``); the prediction paths keep the library's solve.

One set of factors (``_common``: L = chol(Kuu + jitter), A = L⁻¹Kuf/σ,
LB = chol(I + AAᵀ), c = LB⁻¹AY/σ), by triangular solves, serves the bound,
``predict_f`` and ``posterior_alpha`` / ``posterior_stats``; the
predictions share one solve route, so that the per-component predictions of
``sobol.get_prediction_component`` sum to ``predict_f``'s mean. The bound takes them from its sums over rows
(``elbo_terms``), which the shards of a data-sharded fit add. ``oak_tpu``'s
refined variant of the factors exists for the bf16 inside XLA:TPU's solvers
and is not needed here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import like
from ..kernels.oak_kernel import OAKKernel
from ..ops.gemmt import SymProduct
from ..ops.psd import cholesky, solve_lower, solve_lower_wide, solve_upper
from ..params import Param, fixed, log_prior_density, param
from ..utils.profiling import spanned
from .gpr import as_data
from .likelihoods import Gaussian

_LOG2PI = math.log(2.0 * math.pi)


class SGPR(nn.Module):
    _fields = ("kernel", "likelihood", "Z", "X", "Y")

    def __init__(self, kernel: OAKKernel, likelihood: Gaussian, Z: Param,
                 X: torch.Tensor, Y: torch.Tensor):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.Z = Z  # [M, D]
        self.register_buffer("X", X)
        self.register_buffer("Y", Y)

    @classmethod
    def create(cls, X, Y, kernel: OAKKernel, Z, noise_variance: float = 1.0,
               trainable_Z: bool = False, dtype: Optional[torch.dtype] = None,
               device=None) -> "SGPR":
        """Built in ``kernel``'s dtype and device unless told otherwise."""
        dtype, device = like(kernel, dtype, device)
        X, Y = as_data(X, Y, dtype, device)
        kw = dict(dtype=dtype, device=device)
        Zp = param(Z, **kw) if trainable_Z else fixed(Z, **kw)
        return cls(kernel, Gaussian.create(noise_variance, **kw), Zp, X, Y)

    # ------------------------------------------------------------------ #
    def _common(self):
        """(L, A, LB, c, σ²); Kuu gets the dtype's relative jitter, B none."""
        sigma2 = self.likelihood.variance.value
        sigma = torch.sqrt(sigma2)
        Z = self.Z.value
        L = cholesky(self.kernel.K(Z))
        A = solve_lower(L, self.kernel.K(Z, self.X)) / sigma  # [M, N]
        B = A @ A.T + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        LB = cholesky(B, jitter=0.0)
        c = solve_lower(LB, A @ self.Y) / sigma  # [M, R]
        return L, A, LB, c, sigma2

    def elbo_terms(self, X: torch.Tensor, Y: torch.Tensor,
                   sigma: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """The bound's sums over the rows of (X, Y), with A = L⁻¹Kuf/σ
        [M, n]: (AAᵀ, AY, Σ y², Σ K_diag, Σ A²). AAᵀ is one symmetric
        product (``SymProduct``: one triangle computed, a one-product
        backward), and Σ A² its trace, with no pass over A of its own. The
        shards of a data-sharded fit add their terms (``parallel``); LB, c
        and the clamps come from the sums (``elbo_from_terms``), never per
        shard."""
        if sigma is None:
            sigma = torch.sqrt(self.likelihood.variance.value)
        Z = self.Z.value
        L = cholesky(self.kernel.K(Z))
        A = solve_lower_wide(L, self.kernel.K(Z, X)) / sigma  # [M, n]
        AAT = SymProduct.apply(A)
        return (AAT, A @ Y, torch.sum(Y * Y), torch.sum(self.kernel.K_diag(X)),
                torch.diagonal(AAT, dim1=-2, dim2=-1).sum(-1))

    def elbo_from_terms(self, terms, num_rows: int, sigma2: Optional[torch.Tensor] = None,
                        sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Titsias bound from ``elbo_terms`` over ``num_rows`` rows,
        with its exact-arithmetic inequalities enforced (PARITY_NOTES 9):

            ||c||² <= yᵀy / σ²              (Aᵀ B⁻¹ A is a contraction),
            tr(AAᵀ) <= Σ K_diag / σ²        (the Nyström Q_ff ⪯ K_ff),
            diag(LB) >= 1                   (B = I + AAᵀ ⪰ I).

        A float32 fit in the interpolation-collapse basin (noise at its
        floor, a near-singular jittered Kuu) breaks all three by orders of
        magnitude and an optimizer then maximizes the error; the clamps are
        inactive at healthy parameters. ``sigma2`` and ``sigma``, when given,
        are the nodes the terms were made with (one autograd graph, as one
        device's bound has)."""
        AAT, AY, yy, kdiag_sum, trace_term = terms
        if sigma2 is None:
            sigma2 = self.likelihood.variance.value
            sigma = torch.sqrt(sigma2)
        LB = cholesky(AAT + torch.eye(AAT.shape[0], dtype=AAT.dtype, device=AAT.device),
                      jitter=0.0)
        c = solve_lower(LB, AY) / sigma  # [M, R]
        N, R = num_rows, AY.shape[1]
        ydata = 0.5 * yy / sigma2
        one = torch.ones((), dtype=LB.dtype, device=LB.device)
        return (-0.5 * N * R * _LOG2PI
                - R * torch.sum(torch.log(torch.maximum(torch.diagonal(LB), one)))
                - 0.5 * N * R * torch.log(sigma2)
                - ydata
                + torch.minimum(0.5 * torch.sum(c * c), ydata)
                - 0.5 * R * torch.clamp_min(kdiag_sum / sigma2 - trace_term, 0.0))

    def elbo(self) -> torch.Tensor:
        sigma2 = self.likelihood.variance.value
        sigma = torch.sqrt(sigma2)
        return self.elbo_from_terms(self.elbo_terms(self.X, self.Y, sigma), self.Y.shape[0],
                                    sigma2, sigma)

    @spanned("oak.bound")
    def training_loss_from_terms(self, terms, num_rows: int) -> torch.Tensor:
        return -(self.elbo_from_terms(terms, num_rows) + log_prior_density(self))

    @spanned("oak.bound")
    def training_loss(self) -> torch.Tensor:
        return -(self.elbo() + log_prior_density(self))

    # ------------------------------------------------------------------ #
    def predict_factors(self) -> Dict[str, torch.Tensor]:
        """What ``predict_f`` needs that does not depend on Xnew: Z and
        ``_common``'s L, LB and c (Kuf over the N training rows, two
        Choleskys)."""
        L, _, LB, c, _ = self._common()
        return {"Z": self.Z.value, "L": L, "LB": LB, "c": c}

    def predict_f_from(self, factors: Dict[str, torch.Tensor], Xnew: torch.Tensor,
                       full_cov: bool = False, kernel=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``predict_f`` on ``predict_factors``: Kus, K_diag and two
        triangular solves, with no host synchronisation (``serving`` traces
        it).

        ``kernel``, if given, takes the model kernel's place in K and K_diag:
        the posterior of one additive component (``plotting``)."""
        k = self.kernel if kernel is None else kernel
        c = factors["c"]
        tmp1 = solve_lower(factors["L"], k.K(factors["Z"], Xnew))  # [M, S]
        tmp2 = solve_lower(factors["LB"], tmp1)
        mean = tmp2.T @ c
        if full_cov:
            return mean, k.K(Xnew) - tmp1.T @ tmp1 + tmp2.T @ tmp2
        var = (k.K_diag(Xnew) - torch.sum(tmp1 * tmp1, dim=0)
               + torch.sum(tmp2 * tmp2, dim=0))
        return mean, var[:, None].repeat(1, c.shape[1])

    def predict_f(self, Xnew: torch.Tensor, full_cov: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean [S, R] and variance [S, R], or covariance [S, S] shared by
        the R outputs with ``full_cov``."""
        return self.predict_f_from(self.predict_factors(), Xnew, full_cov)

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
        """alpha = L⁻ᵀ LB⁻ᵀ c [M, R], with predictive mean = K(Xnew, Z)
        alpha."""
        L, _, LB, c, _ = self._common()
        return solve_upper(L, solve_upper(LB, c))

    def posterior_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha, Qinv): predictive mean = Kxu alpha, covariance = Kxx -
        Kxu Qinv Kux, with alpha = L⁻ᵀ LB⁻ᵀ c and Qinv = L⁻ᵀ (I - B⁻¹) L⁻¹
        (the reference's hand-derived SGPR statistics)."""
        L, _, LB, c, _ = self._common()
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        Linv = solve_lower(L, eye)
        LBinv_Linv = solve_lower(LB, Linv)
        alpha = solve_upper(L, solve_upper(LB, c))
        return alpha, Linv.T @ Linv - LBinv_Linv.T @ LBinv_Linv

    @property
    def data(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.X, self.Y

    @property
    def inducing_points(self) -> torch.Tensor:
        return self.Z.value
