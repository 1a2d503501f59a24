"""The Duvenaud-style product-kernel path (``oak_tpu.legacy``): an additive
GP written as an explicit *list* of product kernels, one per selected tuple
of dims, plus a constant kernel. Each factor is an ``OrthogonalRBF`` with its
own variance, the "Additive GPs" (Duvenaud 2011) parameterisation, where the
OAK kernel shares one variance per order. The reference uses it for
baselines and for the Sobol indices of hand-built kernel lists.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .config import like
from .kernels import OrthogonalRBF
from .kernels.oak_kernel import kernel_K, kernel_K_diag
from .measures import EmpiricalMeasure, GaussianMeasure, Measure
from .params import Param, bounded, positive
from .sobol import compute_L_for_kernel


class ConstantKernel(nn.Module):
    """``gpflow.kernels.Constant``: variance times ones."""

    _fields = ("variance",)

    def __init__(self, variance: Param):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 1.0, dtype: Optional[torch.dtype] = None,
               device=None) -> "ConstantKernel":
        return cls(positive(variance, dtype=dtype, device=device))

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = X.shape[0] if X2 is None else X2.shape[0]
        return self.variance.value * X.new_ones((X.shape[0], m))

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        return self.variance.value * X.new_ones((X.shape[0],))


class ProductKernel(nn.Module):
    """Product of constrained 1-D kernels over distinct dims
    (``gpflow.kernels.Product`` for this use)."""

    _fields = ("kernels",)

    def __init__(self, kernels: Sequence[nn.Module]):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    @property
    def active_dims(self) -> List[int]:
        return [k.active_dim for k in self.kernels]

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X2 = X if X2 is None else X2
        out = None
        for k in self.kernels:
            g = kernel_K(k, X[:, k.active_dim], X2[:, k.active_dim])
            out = g if out is None else out * g
        return out

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        out = None
        for k in self.kernels:
            g = kernel_K_diag(k, X[:, k.active_dim])
            out = g if out is None else out * g
        return out


def grammer_to_kernel(
    selected_dims: Sequence[Sequence[int]],
    offset: int = 0,
    measure: Optional[Measure] = None,
    lengthscales_lo: float = 1e-3,
    lengthscales_hi: float = 100.0,
    variance_lo: float = 0.01,
    variance_hi: float = 100.0,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> List[nn.Module]:
    """A product kernel for each selected tuple of dims, with bounded
    hyperparameters drawn from numpy's ``default_rng(seed)`` (the draws of
    ``oak_tpu``), then a constant kernel of variance 10. Factors after the
    first have a fixed unit variance, as in the reference. Built in the
    measure's dtype and device unless told otherwise; the default measure
    is N(0, 10) in ``config.resolve``'s."""
    if measure is None:
        measure = GaussianMeasure.create(0.0, 10.0, dtype=dtype, device=device)
    dtype, device = like(measure, dtype, device)
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    out: List[nn.Module] = []
    for dims in selected_dims:
        factors = []
        for j, d in enumerate(dims):
            ls = float(rng.uniform(lengthscales_lo, lengthscales_hi))
            var = float(rng.uniform(variance_lo, variance_hi))
            dim = d + offset
            m = (EmpiricalMeasure.create(measure.location[:, dim].cpu().numpy(), **kw)
                 if isinstance(measure, EmpiricalMeasure) else measure)
            variance = (bounded(variance_lo, variance_hi, var, **kw) if j == 0
                        else positive(1.0, trainable=False, **kw))
            factors.append(OrthogonalRBF(bounded(lengthscales_lo, lengthscales_hi, ls, **kw),
                                         variance, m, active_dim=dim))
        out.append(ProductKernel(factors))
    out.append(ConstantKernel.create(10.0, **kw))
    return out


def extract_active_dims(kernel_list: Sequence) -> List[List[int]]:
    """The active dims of each non-constant kernel."""
    out = []
    for k in kernel_list:
        if isinstance(k, ProductKernel):
            out.append(list(k.active_dims))
        elif not isinstance(k, ConstantKernel):
            out.append([k.active_dim])
    return out


def model_to_kernel_list(kernel_list: Sequence, selected_dims: Sequence) -> List:
    """The kernels reordered to ``selected_dims``, the constant kernel last."""
    dims_of = extract_active_dims(kernel_list)
    non_const = [k for k in kernel_list if not isinstance(k, ConstantKernel)]
    out = []
    for want in selected_dims:
        out += [k for k, have in zip(non_const, dims_of) if list(want) == have]
    out += [k for k in kernel_list if isinstance(k, ConstantKernel)]
    return out


@torch.no_grad()
def compute_sobol(X, kernel_list: Sequence, alpha, delta=None, mu=None) -> List[float]:
    """The Sobol index alphaᵀ (Π_d L_d) alpha of each product kernel of the
    list, with L_d built from the factor's own variance. ``X`` is the
    training inputs (full GP) or the inducing points (sparse); ``delta`` /
    ``mu`` replace each Gaussian factor's Sobol measure (None keeps the
    factor's own). X and alpha move to the kernels' dtype and device."""
    kernels = [k for k in kernel_list if not isinstance(k, ConstantKernel)]
    if not kernels:
        return []
    kw = dict(zip(("dtype", "device"), like(kernels[0])))
    X = torch.as_tensor(X, **kw)
    a = torch.as_tensor(alpha, **kw).reshape(-1)
    out = []
    for k in kernels:
        factors = k.kernels if isinstance(k, ProductKernel) else (k,)
        L = None
        for f in factors:
            Lf = compute_L_for_kernel(f, X[:, f.active_dim], delta=delta, mu=mu)
            L = Lf if L is None else L * Lf
        out.append(a @ L @ a)
    return torch.stack(out).cpu().tolist()
