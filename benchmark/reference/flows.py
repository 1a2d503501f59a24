"""The per-feature normalising flow of the OAK paper's preprocessing:

    u = log(x - offset),  z = (u + shift) * scale,  T(x) = sinh((asinh(z) + skew) * tail)

with tail = exp(raw_tail), scale = exp(raw_scale), offset = min(x) - 1, and
its objective, the KL divergence of T's push-forward of the data to
N(0, 1) up to a constant: 0.5 mean(T(x)^2) - mean(log T'(x))."""

from __future__ import annotations

from typing import Dict

import torch


def transform(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """T applied to the columns of x [N, K], with parameters [K] each:
    ``skewness``, ``tailweight`` and ``scale`` (positive) and ``shift``,
    ``offset``."""
    z = (torch.log(x - p["offset"]) + p["shift"]) * p["scale"]
    return torch.sinh((torch.asinh(z) + p["skewness"]) * p["tailweight"])


def objective(x: torch.Tensor, raw: Dict[str, torch.Tensor], offset: torch.Tensor) -> torch.Tensor:
    """The summed objective of the K columns at the unconstrained
    parameters ``raw`` (``skewness``, ``log_tailweight``, ``log_scale``,
    ``shift``)."""
    return objective_columns(x, raw, offset).sum()


def objective_columns(x: torch.Tensor, raw: Dict[str, torch.Tensor],
                      offset: torch.Tensor) -> torch.Tensor:
    """Each column's objective [K]."""
    u = torch.log(x - offset)
    t, s = torch.exp(raw["log_tailweight"]), torch.exp(raw["log_scale"])
    z = (u + raw["shift"]) * s
    g = (torch.asinh(z) + raw["skewness"]) * t
    y = torch.sinh(g)
    log_dy = torch.log(torch.cosh(g)) + torch.log(t) - 0.5 * torch.log1p(z * z) + torch.log(s) - u
    return 0.5 * torch.mean(y * y, 0) - torch.mean(log_dy, 0)


def initial_raw(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The flows' starting point: no skew, tail 1, and u standardised."""
    u = torch.log(x - (x.min(0).values - 1.0))
    return {"skewness": torch.zeros_like(u[0]), "log_tailweight": torch.zeros_like(u[0]),
            "log_scale": -torch.log(u.std(0, unbiased=False)), "shift": -u.mean(0)}


def offset_of(x: torch.Tensor) -> torch.Tensor:
    return x.min(0).values - 1.0


def raw_of(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The unconstrained parameters of the constrained ``p``."""
    return {"skewness": p["skewness"], "log_tailweight": torch.log(p["tailweight"]),
            "log_scale": torch.log(p["scale"]), "shift": p["shift"]}


def fit(x: torch.Tensor, rounds: int = 20) -> Dict[str, torch.Tensor]:
    """The flows of the columns of x [N, K] fitted from ``initial_raw`` by
    L-BFGS with a strong-Wolfe linesearch, in x's dtype, until the
    objective stops moving: the constrained parameters, as ``transform``
    takes them."""
    offset = offset_of(x)
    raw = {k: v.clone().requires_grad_(True) for k, v in initial_raw(x).items()}
    opt = torch.optim.LBFGS(list(raw.values()), lr=1.0, max_iter=500, history_size=50,
                            tolerance_grad=1e-14, tolerance_change=1e-16,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        value = objective(x, raw, offset)
        value.backward()
        return value

    last = float("inf")
    for _ in range(rounds):
        value = float(opt.step(closure).detach())
        if value >= last:
            break
        last = value
    raw = {k: v.detach() for k, v in raw.items()}
    return {"skewness": raw["skewness"], "tailweight": torch.exp(raw["log_tailweight"]),
            "scale": torch.exp(raw["log_scale"]), "shift": raw["shift"], "offset": offset}
