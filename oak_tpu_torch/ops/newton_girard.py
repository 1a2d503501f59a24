"""Newton–Girard elementary symmetric polynomials (``oak_tpu.ops.newton_girard``).

For per-dim grams k_1..k_D (all [N, M], or diagonals [N]):

    e_0 = 1,   e_n = (1/n) Σ_{p=1..n} (-1)^(p-1) e_{n-p} s_p,   s_p = Σ_i k_i^p

Power sums are accumulated one dimension at a time, so an iterable of grams
is consumed with (P + 1) grams alive, not D; or one stacked group of grams at
a time (``power_sums_stacked``), reduced over its leading group axis.
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, Optional, Sequence

import torch


def power_sums(grams: Iterable[torch.Tensor], depth: int) -> List[torch.Tensor]:
    """s_p = Σ_i grams[i]**p for p = 1..depth, by repeated multiplication.
    Entries stay None when ``grams`` is empty."""
    s = [None] * depth
    for g in grams:
        gp = g
        for p in range(depth):
            s[p] = gp if s[p] is None else s[p] + gp
            if p + 1 < depth:
                gp = gp * g
    return s


def power_sums_stacked(stack: torch.Tensor, depth: int,
                       s: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """``s`` (or new sums) plus the power sums of a stacked group of grams
    [G, ...]: s_p += Σ_g stack[g]**p, p = 1..depth, each a reduction over
    the group axis. Power sums do not depend on the order of the grams, so
    a group's batched buffer is reduced as it is, never sliced per dim."""
    s = [None] * depth if s is None else s
    vp = stack
    for p in range(depth):
        contrib = vp.sum(0)
        s[p] = contrib if s[p] is None else s[p] + contrib
        if p + 1 < depth:
            vp = vp * stack
    return s


def newton_girard_from_power_sums(s: Sequence[torch.Tensor],
                                  depth: int) -> List[torch.Tensor]:
    """[e_0, ..., e_depth] from power sums s_1..s_depth."""
    e = [torch.ones_like(s[0])]
    for n in range(1, depth + 1):
        acc = None
        for p in range(1, n + 1):
            term = e[n - p] * s[p - 1] if n - p > 0 else s[p - 1]
            term = term if p % 2 == 1 else -term
            acc = term if acc is None else acc + term
        e.append(acc / n)
    return e


def newton_girard(grams: Iterable[torch.Tensor], depth: int) -> List[torch.Tensor]:
    """[e_0, ..., e_depth], each shaped like the grams."""
    s = power_sums(grams, depth)
    if s[0] is None:
        raise ValueError("need at least one gram")
    return newton_girard_from_power_sums(s, depth)


def newton_girard_stacked(stack: torch.Tensor, depth: int) -> torch.Tensor:
    """[e_0, ..., e_depth] of a stacked [D, ...] array, as [depth + 1, ...]."""
    if stack.shape[0] == 0:
        raise ValueError("need at least one gram")
    return torch.stack(newton_girard_from_power_sums(power_sums_stacked(stack, depth),
                                                     depth))


def elementary_symmetric_bruteforce(grams: Sequence[torch.Tensor],
                                    depth: int) -> List[torch.Tensor]:
    """O(C(D, n)) direct enumeration, for tests only."""
    grams = list(grams)
    out = [torch.ones_like(grams[0])]
    for n in range(1, depth + 1):
        acc = torch.zeros_like(grams[0])
        for combo in itertools.combinations(range(len(grams)), n):
            prod = grams[combo[0]]
            for i in combo[1:]:
                prod = prod * grams[i]
            acc = acc + prod
        out.append(acc)
    return out
