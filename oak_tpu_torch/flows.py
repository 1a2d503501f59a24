"""Per-feature normalising flow that Gaussianises continuous inputs
(``oak_tpu.flows``):

    T(x) = SinhArcsinh_{skew, tail}((u + shift) * scale),  u = log(x - offset) or x

with trainable (skew, tail, scale, shift) and ``offset = min(x) - 1`` fixed
when the log branch is on. SinhArcsinh is Y = sinh((asinh(X) + skew) * tail).
Training minimises

    KL(T#p_data || N(0, 1)) ~ 0.5 E[T(x)^2] - E[log |T'(x)|].

A ``Normalizer`` is an ``nn.Module`` whose fields carry the JAX key paths
(``.skewness.raw``, ``.tailweight.raw``, ``.scale.raw``, ``.shift.raw``,
``.offset``), so that an ``oak_model`` checkpoint's ``flow{i}`` entries load
in either package. ``plot_flow`` is not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .bijectors import Exp
from .config import resolve
from .params import Param, param


class Normalizer(nn.Module):
    _fields = ("skewness", "tailweight", "scale", "shift", "offset")

    def __init__(self, skewness: Param, tailweight: Param, scale: Param, shift: Param,
                 offset: torch.Tensor, log: bool = False):
        super().__init__()
        self.skewness = skewness
        self.tailweight = tailweight  # Exp-transformed (positive)
        self.scale = scale  # Exp-transformed (positive), init 1/std
        self.shift = shift  # init -mean
        self.register_buffer("offset", offset)  # only used when log=True
        self.log = log

    @classmethod
    def create(cls, x: np.ndarray, log: bool = True, dtype: Optional[torch.dtype] = None,
               device=None) -> "Normalizer":
        """A flow with scalar parameters initialised from one column x, in
        ``dtype`` on ``device`` (``config.resolve``)."""
        x = np.asarray(x, np.float64).reshape(-1)
        return _build(x[:, None], log, dtype, device, scalar=True)

    # ------------------------------------------------------------------ #
    def _u(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(x - self.offset) if self.log else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = (self._u(x) + self.shift.value) * self.scale.value
        t = self.tailweight.value
        return torch.sinh((torch.asinh(z) + self.skewness.value) * t)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        t = self.tailweight.value
        z = torch.sinh(torch.asinh(y) / t - self.skewness.value)
        u = z / self.scale.value - self.shift.value
        return torch.exp(u) + self.offset if self.log else u

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        u = self._u(x)
        z = (u + self.shift.value) * self.scale.value
        t = self.tailweight.value
        g = (torch.asinh(z) + self.skewness.value) * t
        # log cosh(g) without overflow for |g| > ~88 in f32
        log_cosh = torch.abs(g) + torch.log1p(torch.exp(-2.0 * torch.abs(g))) - math.log(2.0)
        fldj = log_cosh + torch.log(t) - 0.5 * torch.log1p(z * z) + torch.log(self.scale.value)
        if self.log:
            fldj = fldj - u
        return fldj

    # ------------------------------------------------------------------ #
    def kl_objective(self, x: torch.Tensor) -> torch.Tensor:
        """KL to N(0, 1) up to a constant."""
        y = self.forward(x)
        return 0.5 * torch.mean(y * y) - torch.mean(self.forward_log_det_jacobian(x))

    def KL_objective(self, x) -> torch.Tensor:
        """The reference's name for ``kl_objective``; takes numpy too."""
        return self.kl_objective(self.as_input(x))

    def as_input(self, x) -> torch.Tensor:
        """x as a tensor of the flow's dtype on its device."""
        return torch.as_tensor(x, dtype=self.offset.dtype, device=self.offset.device)


def _build(X_cols: np.ndarray, log: bool, dtype, device, scalar: bool) -> Normalizer:
    """A Normalizer initialised from the columns of X_cols [N, K]: vector
    parameters [K], or scalars when ``scalar`` (K = 1)."""
    dtype, device = resolve(dtype, device)
    if log:
        offset = X_cols.min(axis=0) - 1.0
        u = np.log(X_cols - offset[None, :])
    else:
        offset = np.zeros(X_cols.shape[1])
        u = X_cols
    shape = () if scalar else (X_cols.shape[1],)

    def vals(v):
        return np.asarray(v, np.float64).reshape(shape)

    kw = dict(dtype=dtype, device=device)
    return Normalizer(
        skewness=param(vals(np.zeros(X_cols.shape[1])), **kw),
        tailweight=param(vals(np.ones(X_cols.shape[1])), Exp(), **kw),
        scale=param(vals(1.0 / u.std(axis=0)), Exp(), **kw),
        shift=param(vals(-u.mean(axis=0)), **kw),
        offset=torch.as_tensor(vals(offset), **kw),
        log=log,
    )


def fit_normalizer(x: np.ndarray, log: bool = True, max_iters: int = 200,
                   dtype: Optional[torch.dtype] = None, device=None,
                   optimizer: str = "lbfgs") -> Normalizer:
    """Build and fit a Normalizer on one feature column, by the port's
    L-BFGS (default) or scipy's L-BFGS-B."""
    from .optim import fit_lbfgs, fit_scipy

    n = Normalizer.create(x, log=log, dtype=dtype, device=device)
    xt = n.as_input(np.asarray(x, np.float64).reshape(-1))
    if optimizer == "scipy":
        fit_scipy(n, lambda m: m.kl_objective(xt), method="L-BFGS-B", max_iters=max_iters)
    else:
        fit_lbfgs(n, lambda m: m.kl_objective(xt), max_iters=max_iters)
    return n


def _stacked_normalizer(X_cols: np.ndarray, log: bool, dtype: Optional[torch.dtype] = None,
                        device=None) -> Normalizer:
    """One Normalizer with vector parameters [K] over K feature columns."""
    return _build(np.asarray(X_cols, np.float64), log, dtype, device, scalar=False)


def fit_normalizers(X_cols: np.ndarray, log: bool = True, max_iters: int = 200,
                    dtype: Optional[torch.dtype] = None, device=None) -> List[Normalizer]:
    """Fit flows for K feature columns in one L-BFGS run over the stacked
    [K] parameters (the per-dim objectives are independent, so their mean
    optimises each), then split them into K scalar-parameter Normalizers.
    ``dtype``, ``device``: ``config.resolve``."""
    from .optim import fit_lbfgs

    X_cols = np.asarray(X_cols, np.float64)
    n = _stacked_normalizer(X_cols, log, dtype, device)
    xt = n.as_input(X_cols)
    fit_lbfgs(n, lambda m: m.kl_objective(xt), max_iters=max_iters)

    def part(p: Param, k: int) -> Param:
        return Param(p.raw.detach()[k].clone(), bij=p.bij, trainable=p.trainable,
                     prior=p.prior)

    return [Normalizer(part(n.skewness, k), part(n.tailweight, k), part(n.scale, k),
                       part(n.shift, k), n.offset[k].clone(), log=log)
            for k in range(X_cols.shape[1])]


def kstest(normalizer: Normalizer, x) -> tuple:
    """KS normality test of the transformed data, through scipy."""
    from scipy import stats

    with torch.no_grad():
        y = normalizer.forward(normalizer.as_input(np.asarray(x).reshape(-1)))
    return stats.kstest(y.cpu().numpy(), "norm")
