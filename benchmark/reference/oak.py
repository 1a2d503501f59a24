"""The OAK kernel of Lu, Boukouvalas and Hensman (arXiv:2206.09861), its
parameter transforms and Adam, written out in plain torch.

Each input dimension d has a one-dimensional squared-exponential kernel
made orthogonal to the constant function under the measure N(mu, delta2):

    k(x, x')  = v exp(-(x - x')^2 / (2 l^2))
    c(x)      = int k(x, s) dN(s)   = v l / sqrt(l^2 + delta2) exp(-(x - mu)^2 / (2 (l^2 + delta2)))
    var_s     = int int k dN dN     = v l / sqrt(l^2 + 2 delta2)
    g(x, x')  = k(x, x') - c(x) c(x') / var_s

and the OAK gram is sum_n sigma2_n e_n(g_1, ..., g_D), with e_n the
elementary symmetric polynomials, here by the product expansion
prod_d (1 + t g_d) one dimension at a time (not by Newton-Girard).

``Precision`` carries the dtype and the matrix product: the reference runs
in float64 with exact products; its control runs in float32 with every
matrix product's operands rounded to TF32 (10 stored mantissa bits), which
is what the card's tensor cores compute with TF32 on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return to_tf32(a) @ to_tf32(b)
        return a @ b


F64 = Precision()
TF32 = Precision(torch.float32, tf32=True)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


# --------------------------------------------------------------------------- #
# Transforms of the unconstrained values
# --------------------------------------------------------------------------- #
def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: float) -> float:
    return y + math.log(-math.expm1(-y))


def sigmoid_bounded(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * torch.sigmoid(x)


def inv_sigmoid_bounded(y: float, low: float, high: float) -> float:
    z = (y - low) / (high - low)
    return math.log(z) - math.log1p(-z)


# --------------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------------- #
def dim_gram(x: torch.Tensor, x2: torch.Tensor, l: torch.Tensor, v=1.0, mu=0.0,
             delta2=1.0) -> torch.Tensor:
    """g_d between the columns x [N] and x2 [M]: [N, M]."""
    base = v * torch.exp(-(x[:, None] - x2[None, :]) ** 2 / (2.0 * l * l))
    return base - cov(x, l, v, mu, delta2)[:, None] * cov(x2, l, v, mu, delta2)[None, :] \
        / var_s(l, v, delta2)


def dim_diag(x: torch.Tensor, l: torch.Tensor, v=1.0, mu=0.0, delta2=1.0) -> torch.Tensor:
    return v - cov(x, l, v, mu, delta2) ** 2 / var_s(l, v, delta2)


def cov(x, l, v=1.0, mu=0.0, delta2=1.0):
    t = l * l + delta2
    return v * l / torch.sqrt(t) * torch.exp(-(x - mu) ** 2 / (2.0 * t))


def var_s(l, v=1.0, delta2=1.0):
    return v * l / torch.sqrt(l * l + 2.0 * delta2)


def elementary(grams, depth: int) -> List[torch.Tensor]:
    """[e_1, ..., e_depth] of the grams, by the product expansion."""
    e = [None] * (depth + 1)
    for g in grams:
        for n in range(depth, 0, -1):
            lower = g if n == 1 else (None if e[n - 1] is None else e[n - 1] * g)
            if lower is not None:
                e[n] = lower if e[n] is None else e[n] + lower
    return [t if t is not None else torch.zeros_like(grams[0]) for t in e[1:]]


def oak_gram(X: torch.Tensor, X2: torch.Tensor, ls: torch.Tensor,
             sig2: torch.Tensor) -> torch.Tensor:
    """sum_n sigma2_n e_n over the columns of X [N, D], X2 [M, D], for
    lengthscales ls [D] and order variances sig2 [P + 1]; base variances 1,
    measure N(0, 1)."""
    depth = sig2.shape[0] - 1
    grams = [dim_gram(X[:, d], X2[:, d], ls[d]) for d in range(X.shape[1])]
    e = elementary(grams, depth)
    out = sig2[0] * torch.ones_like(grams[0])
    for n, en in enumerate(e, start=1):
        out = out + sig2[n] * en
    return out


def oak_diag(X: torch.Tensor, ls: torch.Tensor, sig2: torch.Tensor) -> torch.Tensor:
    depth = sig2.shape[0] - 1
    diags = [dim_diag(X[:, d], ls[d]) for d in range(X.shape[1])]
    e = elementary(diags, depth)
    out = sig2[0] * torch.ones_like(diags[0])
    for n, en in enumerate(e, start=1):
        out = out + sig2[n] * en
    return out


def gamma_log_prob(x: torch.Tensor, concentration: float, rate: float) -> torch.Tensor:
    out = concentration * math.log(rate) - math.lgamma(concentration) - rate * x
    if concentration != 1.0:
        out = out + (concentration - 1.0) * torch.log(x)
    return out


def jittered(K: torch.Tensor, jitter: float, relative: bool) -> torch.Tensor:
    """K + j I, with j = jitter, or jitter times the mean diagonal floored
    at 1 when ``relative``."""
    j = jitter
    if relative:
        j = jitter * torch.clamp_min(torch.mean(torch.diagonal(K)), 1.0)
    return K + j * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)


def lower_inverse(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


# --------------------------------------------------------------------------- #
# Adam
# --------------------------------------------------------------------------- #
class Adam:
    """Adam (Kingma and Ba) with beta 0.9 / 0.999 and eps 1e-8, on a dict of
    leaves."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for k, x in leaves.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            out[k] = x - self.lr * mhat / (torch.sqrt(vhat) + eps)
        return out


def value_and_grad(loss_fn, leaves: Dict[str, torch.Tensor]):
    """(loss, {leaf: gradient}) of ``loss_fn(leaves)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, (g.detach() for g in grads)))
