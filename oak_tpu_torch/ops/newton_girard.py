"""Newton–Girard elementary symmetric polynomials (``oak_tpu.ops.newton_girard``).

For per-dim grams k_1..k_D (all [N, M], or diagonals [N]):

    e_0 = 1,   e_n = (1/n) Σ_{p=1..n} (-1)^(p-1) e_{n-p} s_p,   s_p = Σ_i k_i^p

Power sums are accumulated one dimension at a time, so an iterable of grams
is consumed with (P + 1) grams alive, not D.
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, Sequence

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
