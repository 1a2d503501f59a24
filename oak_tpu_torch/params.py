"""Constrained parameters as ``nn.Module``s.

A ``Param`` holds one unconstrained ``nn.Parameter`` (``raw``) plus a
bijector, a trainable flag and an optional prior, like ``oak_tpu.params.Param``.

Every model class of the port lists its fields, in the order the JAX package
declares them, in ``_fields``. ``keypath_nodes`` walks those fields and gives
each array leaf the key path JAX's ``keystr`` gives it
(``.kernel.kernels[0].lengthscale``), so that the trainable order matches
``oak_tpu.params.flatten_trainable`` and checkpoints cross-load
(``oak_tpu_torch.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from .bijectors import Bijector, Identity, Sigmoid, Softplus
from .config import resolve


# --------------------------------------------------------------------------- #
# Priors
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Prior:
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    """Gamma(concentration, rate); Gamma(1, 0.2) is the sparsity prior on the
    per-order variances."""

    concentration: float
    rate: float

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        out = a * math.log(b) - math.lgamma(a) - b * x
        # a == 1 must not evaluate 0 * log(0) = NaN as a variance shrinks to 0
        if a != 1.0:
            out = out + (a - 1.0) * torch.log(x)
        return out


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    loc: float
    scale: float

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - math.log(self.scale) - 0.5 * math.log(2.0 * math.pi)


# --------------------------------------------------------------------------- #
# Param
# --------------------------------------------------------------------------- #
class Param(nn.Module):
    def __init__(self, raw: torch.Tensor, bij: Bijector = Identity(),
                 trainable: bool = True, prior: Optional[Prior] = None):
        super().__init__()
        self.raw = nn.Parameter(raw, requires_grad=trainable)
        self.bij = bij
        self.trainable = trainable
        self.prior = prior

    @property
    def value(self) -> torch.Tensor:
        return self.bij.forward(self.raw)

    @torch.no_grad()
    def assign(self, constrained_value) -> "Param":
        """Set the raw value so that ``value`` equals ``constrained_value``."""
        v = torch.as_tensor(constrained_value, dtype=self.raw.dtype,
                            device=self.raw.device)
        self.raw.copy_(self.bij.inverse(v).expand_as(self.raw))
        return self

    def log_prior_density(self) -> torch.Tensor:
        """Prior density of the *constrained* value (GPflow's default)."""
        if self.prior is None or not self.trainable:
            return torch.zeros((), dtype=self.raw.dtype, device=self.raw.device)
        return torch.sum(self.prior.log_prob(self.value))


class StackedParam:
    """A group's Params as one: ``raw`` is ``torch.stack`` of the members'
    raws [G, ...], so the gradient of anything computed from it reaches
    every member's ``nn.Parameter``, and ``value`` applies their shared
    bijector once. Not a module and not registered anywhere: it lives for
    one evaluation (``kernels.stack_group``)."""

    def __init__(self, members: List[Param]):
        first = members[0]
        self.raw = torch.stack([p.raw for p in members])
        self.bij, self.trainable, self.prior = first.bij, first.trainable, first.prior

    @functools.cached_property
    def value(self) -> torch.Tensor:
        return self.bij.forward(self.raw)


def param(value, bij: Bijector = Identity(), trainable: bool = True, prior=None,
          dtype: Optional[torch.dtype] = None, device=None) -> Param:
    """A Param whose constrained value is ``value``, in ``dtype`` on
    ``device`` (float32 on the card when None, ``config.resolve``)."""
    dtype, device = resolve(dtype, device)
    v = torch.as_tensor(value, dtype=dtype, device=device)
    return Param(bij.inverse(v).clone(), bij=bij, trainable=trainable, prior=prior)


def positive(value, low: float = 0.0, trainable: bool = True, prior=None,
             dtype: Optional[torch.dtype] = None, device=None) -> Param:
    return param(value, Softplus(low=low), trainable=trainable, prior=prior,
                 dtype=dtype, device=device)


def bounded(low: float, high: float, value, trainable: bool = True, prior=None,
            dtype: Optional[torch.dtype] = None, device=None) -> Param:
    return param(value, Sigmoid(low=low, high=high), trainable=trainable,
                 prior=prior, dtype=dtype, device=device)


def fixed(value, dtype: Optional[torch.dtype] = None, device=None) -> Param:
    return param(value, Identity(), trainable=False, dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Traversal in the JAX package's pytree order
# --------------------------------------------------------------------------- #
Node = Union[Param, torch.Tensor]


def keypath_nodes(module: nn.Module) -> List[Tuple[str, Node]]:
    """Every ``Param`` and every array buffer, with its JAX key path, in
    the JAX package's flattening order."""
    out: List[Tuple[str, Node]] = []

    def walk(node, path):
        if isinstance(node, (Param, torch.Tensor)):
            out.append((path, node))
        elif isinstance(node, (nn.ModuleList, list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{path}[{i}]")
        else:
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}")

    walk(module, "")
    return out


def iter_params(module: nn.Module) -> List[Tuple[str, Param]]:
    return [(k, p) for k, p in keypath_nodes(module) if isinstance(p, Param)]


def log_prior_density(module: nn.Module) -> torch.Tensor:
    """Sum of the log prior densities of all trainable Params."""
    total = 0.0
    for _, p in iter_params(module):
        total = total + p.log_prior_density()
    return total


def trainable_params(module: nn.Module) -> List[Param]:
    return [p for _, p in iter_params(module) if p.trainable]


def flatten_trainable(module: nn.Module) -> torch.Tensor:
    """The trainable raw values as one vector, in the order of
    ``oak_tpu.params.flatten_trainable``."""
    return torch.cat([p.raw.reshape(-1) for p in trainable_params(module)])


def trainable_names(module: nn.Module) -> List[str]:
    """The attribute path of every trainable raw (``kernel.kernels.0.
    lengthscale.raw``), in ``flatten_trainable``'s order."""
    names = {id(m): name for name, m in module.named_modules()}
    return [f"{names[id(p)]}.raw" if names[id(p)] else "raw"
            for p in trainable_params(module)]


def unflatten_trainable(module: nn.Module, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``flatten_trainable``'s inverse as a mapping from each trainable raw's
    attribute path to a view of ``vec`` shaped like it, for ``call_with``;
    the views keep ``vec``'s autograd graph."""
    params = trainable_params(module)
    pieces = torch.split(vec, [p.raw.numel() for p in params])
    return {name: piece.view(p.raw.shape)
            for name, piece, p in zip(trainable_names(module), pieces, params)}


@torch.no_grad()
def assign_trainable(module: nn.Module, vec: torch.Tensor) -> nn.Module:
    """Write ``vec`` into the trainable raws in place, in
    ``flatten_trainable``'s order (``oak_tpu``'s ``unflatten(vec)``)."""
    params = trainable_params(module)
    sizes = [p.raw.numel() for p in params]
    if vec.shape != (sum(sizes),):
        raise ValueError(f"vector of shape {tuple(vec.shape)} for "
                         f"{sum(sizes)} trainable values")
    for p, piece in zip(params, torch.split(vec, sizes)):
        p.raw.copy_(piece.view(p.raw.shape))
    return module


class _Bound(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def call_with(module: nn.Module, raws: Dict[str, torch.Tensor], fn: Callable, *args):
    """``fn(module, *args)`` with the raws named in ``raws`` (attribute paths,
    as ``trainable_names`` gives them) replaced by the given tensors for the
    call, through ``torch.func.functional_call``: the gradient reaches those
    tensors, and ``module`` is left as it was. The counterpart of calling a
    loss on ``oak_tpu``'s ``unflatten(vec)``."""
    return torch.func.functional_call(
        _Bound(module, fn), {f"model.{k}": v for k, v in raws.items()}, args)
