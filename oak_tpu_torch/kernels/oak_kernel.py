"""The OAK combination kernel (``oak_tpu.kernels.oak_kernel``).

One constrained 1-D kernel per input dimension plus per-order variances
σ²_0..σ²_P:

    K = Σ_n σ²_n e_n(k_1, ..., k_D)

with e_n the elementary symmetric polynomials from Newton–Girard.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, List, Optional, Sequence

import torch
from torch import nn

from ..config import resolve
from ..measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure
from ..ops import oak_gram as og
from ..ops.newton_girard import (newton_girard, newton_girard_from_power_sums,
                                 power_sums)
from ..params import Gamma, Param, bounded, positive
from ..utils.diagnostics import check_matrix_input
from . import ortho_binary, ortho_categorical, ortho_rbf
from .ortho_binary import OrthogonalBinary
from .ortho_categorical import OrthogonalCategorical
from .ortho_rbf import OrthogonalRBF


class UnconstrainedRBF(nn.Module):
    """Plain SE kernel on one dim: the ``constrain_orthogonal=False`` variant."""

    _fields = ("lengthscale", "variance")

    def __init__(self, lengthscale: Param, variance: Param, active_dim: int = 0):
        super().__init__()
        self.lengthscale = lengthscale
        self.variance = variance
        self.active_dim = active_dim

    @classmethod
    def create(cls, lengthscale=1.0, variance=1.0, active_dim: int = 0,
               lengthscale_bounds=None, train_variance: bool = True,
               dtype: Optional[torch.dtype] = None, device=None):
        dtype, device = resolve(dtype, device)
        if lengthscale_bounds is not None:
            ls = bounded(lengthscale_bounds[0], lengthscale_bounds[1], lengthscale,
                         dtype=dtype, device=device)
        else:
            ls = positive(lengthscale, dtype=dtype, device=device)
        return cls(ls, positive(variance, trainable=train_variance, dtype=dtype,
                                device=device), active_dim)


def kernel_K(k, x: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram of one constituent 1-D kernel on already-sliced columns."""
    if isinstance(k, OrthogonalRBF):
        return ortho_rbf.K(k, x, x2)
    if isinstance(k, OrthogonalBinary):
        return ortho_binary.K(k, x, x2)
    if isinstance(k, OrthogonalCategorical):
        return ortho_categorical.K(k, x, x2)
    if isinstance(k, UnconstrainedRBF):
        return ortho_rbf.rbf(k, x, x2)
    raise NotImplementedError(type(k))


def kernel_K_diag(k, x: torch.Tensor) -> torch.Tensor:
    if isinstance(k, OrthogonalRBF):
        return ortho_rbf.K_diag(k, x)
    if isinstance(k, OrthogonalBinary):
        return ortho_binary.K_diag(k, x)
    if isinstance(k, OrthogonalCategorical):
        return ortho_categorical.K_diag(k, x)
    if isinstance(k, UnconstrainedRBF):
        return ortho_rbf.rbf_diag(k, x)
    raise NotImplementedError(type(k))


def per_dim_batched(kernels: Sequence[nn.Module], X: torch.Tensor,
                    fn: Callable) -> List:
    """``fn(kernel, column)`` for every constituent kernel, in dim order.

    A plain loop: ``oak_tpu`` vmaps each group of same-typed kernels to save
    TPU launches; batching the per-dim forms is ROADMAP H1."""
    return [fn(k, X[:, k.active_dim]) for k in kernels]


class OAKKernel(nn.Module):
    _fields = ("kernels", "variances")

    def __init__(self, kernels: Sequence[nn.Module], variances: Sequence[Param],
                 max_interaction_depth: int = 2,
                 share_var_across_orders: bool = True):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.variances = nn.ModuleList(variances)
        self.max_interaction_depth = max_interaction_depth
        self.share_var_across_orders = share_var_across_orders

    @classmethod
    def create(
        cls,
        num_dims: int,
        max_interaction_depth: int = 2,
        active_dims: Optional[Sequence[Sequence[int]]] = None,
        constrain_orthogonal: bool = True,
        p0: Optional[Sequence[Optional[float]]] = None,
        p: Optional[Sequence] = None,
        lengthscale_bounds: Optional[Sequence[float]] = None,
        empirical_locations: Optional[Sequence] = None,
        empirical_weights: Optional[Sequence] = None,
        gmm_measures: Optional[Sequence[Optional[MOGMeasure]]] = None,
        share_var_across_orders: bool = True,
        use_sparsity_prior: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "OAKKernel":
        """Same semantics as ``oak_tpu.kernels.OAKKernel.create``:

        - continuous dims: OrthogonalRBF against N(0, 1), or against an
          empirical / GMM measure when one is given (those keep a trainable
          base variance even when variances are shared across orders);
        - binary dims (p0[d] set): OrthogonalBinary;
        - categorical dims (p[d] set): OrthogonalCategorical, whose W is drawn
          from a generator seeded with the dim's index;
        - share_var_across_orders: base variances pinned to 1 and trainable
          σ²_0..σ²_P; otherwise σ²_0 alone plus trainable base variances;
        - constrain_orthogonal=False: UnconstrainedRBF for continuous dims;
        - dtype, device: float32 on the CUDA card when None
          (``config.resolve``), as ``oak_tpu`` builds in float32 on its chip.
        """
        if active_dims is None:
            active_dims = [[d] for d in range(num_dims)]
        flat = [d for group in active_dims for d in group]
        if len(flat) != len(set(flat)):
            raise ValueError("Active dims contains duplicates.")
        if max(flat) >= num_dims:
            raise ValueError("Active dims exceeding num dims.")
        if any(len(g) != 1 for g in active_dims):
            raise NotImplementedError("active_dims groups must be single dims")
        D = len(active_dims)

        p0 = list(p0) if p0 is not None else [None] * D
        p = list(p) if p is not None else [None] * D
        if empirical_locations is None:
            if empirical_weights is not None:
                raise ValueError("Cannot have weights without locations")
            empirical_locations = [None] * D
            empirical_weights = [None] * D
        elif empirical_weights is None:
            empirical_weights = [None] * D
        if gmm_measures is None:
            gmm_measures = [None] * D
        if not constrain_orthogonal and any(
                loc is not None for loc in empirical_locations):
            raise ValueError("Cannot have empirical locations without orthogonal constraint")

        dtype, device = resolve(dtype, device)
        kw = dict(dtype=dtype, device=device)
        kernels = []
        for d in range(D):
            dim = active_dims[d][0]
            train_var = not share_var_across_orders
            if empirical_locations[d] is not None and gmm_measures[d] is not None:
                raise ValueError(f"Both empirical and GMM measure defined for input {d}")
            if p[d] is not None:
                k = OrthogonalCategorical.create(
                    p=p[d], active_dim=dim, train_variance=train_var,
                    generator=torch.Generator().manual_seed(dim), **kw)
            elif p0[d] is not None:
                # binary in both the constrained and unconstrained variants
                k = OrthogonalBinary.create(p0=p0[d], active_dim=dim,
                                            train_variance=train_var, **kw)
            elif not constrain_orthogonal:
                k = UnconstrainedRBF.create(active_dim=dim,
                                            lengthscale_bounds=lengthscale_bounds,
                                            train_variance=train_var, **kw)
            else:
                rbf_train_var = train_var
                if empirical_locations[d] is not None:
                    measure = EmpiricalMeasure.create(
                        empirical_locations[d], empirical_weights[d], **kw)
                    rbf_train_var = True
                elif gmm_measures[d] is not None:
                    measure = gmm_measures[d].to(**kw)
                    rbf_train_var = True
                else:
                    measure = GaussianMeasure.create(0.0, 1.0, **kw)
                k = OrthogonalRBF.create(measure, active_dim=dim,
                                         lengthscale_bounds=lengthscale_bounds,
                                         train_variance=rbf_train_var, **kw)
            kernels.append(k)

        prior = Gamma(1.0, 0.2) if use_sparsity_prior else None
        if share_var_across_orders:
            variances = [positive(1.0, prior=prior, **kw)
                         for _ in range(max_interaction_depth + 1)]
        else:
            variances = [positive(1.0, **kw)]
        return cls(kernels, variances, max_interaction_depth,
                   share_var_across_orders)

    # ------------------------------------------------------------------ #
    @property
    def num_dims(self) -> int:
        return len(self.kernels)

    def _max_active_dim(self) -> int:
        return max(k.active_dim for k in self.kernels) + 1

    def dim_grams(self, X: torch.Tensor,
                  X2: Optional[torch.Tensor] = None) -> Iterator[torch.Tensor]:
        """The per-dim grams, yielded one at a time."""
        for k in self.kernels:
            x2 = None if X2 is None else X2[:, k.active_dim]
            yield kernel_K(k, X[:, k.active_dim], x2)

    def dim_diags(self, X: torch.Tensor) -> Iterator[torch.Tensor]:
        for k in self.kernels:
            yield kernel_K_diag(k, X[:, k.active_dim])

    def _combine(self, terms: List[torch.Tensor]) -> torch.Tensor:
        out = self.variances[0].value * terms[0]
        if self.share_var_across_orders:
            for v, e in zip(self.variances[1:], terms[1:]):
                out = out + v.value * e
        else:
            for e in terms[1:]:
                out = out + e
        return out

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The OAK gram [N, M].

        Route: the fused gram (``ops.oak_gram.oak_gram``, which launches the
        hand-written CUDA kernel) when all three of these hold:

        1. X is a CUDA tensor;
        2. X is float32;
        3. the structure qualifies (``ops.oak_gram.supports_fused``: at least
           one RBF-form dim, every other dim binary or categorical).

        Otherwise the per-dim Newton–Girard route in plain torch. So the CPU,
        and float64 anywhere, never reach the kernel. The kernels take any
        depth up to ``ops.oak_gram.MAX_DEPTH`` after clamping it to the number
        of dims (64: sonar's D = 60 at full depth); deeper, the wrapper raises.
        """
        check_matrix_input(X, self._max_active_dim(), "X")
        if X2 is not None:
            check_matrix_input(X2, self._max_active_dim(), "X2")
        if X.is_cuda and X.dtype == torch.float32 and og.supports_fused(self):
            return og.oak_gram(self, X, X2)
        e = newton_girard(self.dim_grams(X, X2), self.max_interaction_depth)
        return self._combine(e)

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        """diag(K) [N] through the power sums of the per-dim diagonals."""
        check_matrix_input(X, self._max_active_dim(), "X")
        depth = self.max_interaction_depth
        e = newton_girard_from_power_sums(power_sums(self.dim_diags(X), depth),
                                          depth)
        return self._combine(e)

    # ------------------------------------------------------------------ #
    def component_K(self, dims: Sequence[int], X: torch.Tensor,
                    X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gram of one additive term; ``dims`` indexes into self.kernels and
        an empty ``dims`` is the constant term σ²_0 · 1."""
        n = X.shape[0]
        m = n if X2 is None else X2.shape[0]
        if len(dims) == 0:
            return self.variances[0].value * torch.ones(
                (n, m), dtype=X.dtype, device=X.device)
        out = None
        for d in dims:
            k = self.kernels[d]
            x2 = None if X2 is None else X2[:, k.active_dim]
            g = kernel_K(k, X[:, k.active_dim], x2)
            out = g if out is None else out * g
        if self.share_var_across_orders:
            out = self.variances[len(dims)].value * out
        return out

    def component_K_diag(self, dims: Sequence[int], X: torch.Tensor) -> torch.Tensor:
        """diag of ``component_K(dims, X)``, [N]."""
        if len(dims) == 0:
            return self.variances[0].value * torch.ones(
                (X.shape[0],), dtype=X.dtype, device=X.device)
        out = None
        for d in dims:
            k = self.kernels[d]
            g = kernel_K_diag(k, X[:, k.active_dim])
            out = g if out is None else out * g
        if self.share_var_across_orders:
            out = self.variances[len(dims)].value * out
        return out


def component_index_tuples(num_dims: int, max_interaction_depth: int) -> List[List[int]]:
    """All C(D, 0..P) index tuples, the constant term first."""
    out: List[List[int]] = [[]]
    for order in range(1, max_interaction_depth + 1):
        out.extend([list(c) for c in itertools.combinations(range(num_dims), order)])
    return out


class KernelComponent:
    """One additive term of an OAKKernel as a kernel object, a view over
    ``OAKKernel.component_K`` (``oak_tpu``'s ``KernelComponent``; the
    reference spells it ``KernelComponenent``, kept as an alias)."""

    def __init__(self, oak_kernel: OAKKernel, iComponent_list: Sequence[int],
                 share_var_across_orders: bool = True):
        self.oak_kernel = oak_kernel
        self.iComponent_list = list(iComponent_list)
        self.share_var_across_orders = share_var_across_orders
        self.kernels = [k for i, k in enumerate(oak_kernel.kernels)
                        if i in self.iComponent_list]

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.oak_kernel.component_K(self.iComponent_list, X, X2)

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        return self.oak_kernel.component_K_diag(self.iComponent_list, X)


KernelComponenent = KernelComponent  # the reference's spelling


def get_list_representation(kernel: OAKKernel, num_dims: int,
                            share_var_across_orders: bool = True):
    """(selected_dims, [KernelComponent]): every additive term, the constant
    term first."""
    selected_dims = component_index_tuples(num_dims, kernel.max_interaction_depth)
    components = [KernelComponent(kernel, dims, share_var_across_orders)
                  for dims in selected_dims]
    return selected_dims, components
