"""1-D bijectors for parameter transforms.

Same forward, inverse and log-det-Jacobian formulas as ``oak_tpu.bijectors``;
each bijector is a frozen dataclass holding only Python floats, applied to
torch tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(x)) without torch's linear cut-off above x = 20, so that it
    # equals jax.nn.softplus to the last bit the dtype carries
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Bijector:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """log |dy/dx| at x, elementwise."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class Softplus(Bijector):
    """y = log(1 + exp(x)) + low. GPflow's ``positive()`` transform."""

    low: float = 0.0

    def forward(self, x):
        return _softplus(x) + self.low

    def inverse(self, y):
        # numerically stable inverse softplus: x = z + log(1 - exp(-z))
        z = y - self.low
        return z + torch.log(-torch.expm1(-z))

    def forward_log_det_jacobian(self, x):
        return -_softplus(-x)


@dataclasses.dataclass(frozen=True)
class Exp(Bijector):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class Sigmoid(Bijector):
    """y = low + (high - low) * sigmoid(x), for bounded lengthscales."""

    low: float = 0.0
    high: float = 1.0

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        z = (y - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)

    def forward_log_det_jacobian(self, x):
        return math.log(self.high - self.low) - _softplus(-x) - _softplus(x)
