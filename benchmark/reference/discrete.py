"""The OAK paper's constrained kernels on discrete inputs (Lu, Boukouvalas
and Hensman, arXiv:2206.09861, section 4.2), and the OAK gram over a mix of
continuous, binary and categorical dims, written out in plain torch.

A binary dim under the measure P(x = 0) = p0, P(x = 1) = p1 = 1 - p0 has
the 2 x 2 table, orthogonal to constants under that measure,

    B = [[p1^2, -p0 p1], [-p0 p1, p0^2]]        (variance 1)

and a categorical dim with C levels under the measure p [C] the table

    A = W W^T + diag(kappa),   B = A - (A p)(A p)^T / (p^T A p)

Both are read at the level codes: k(x, x') = B[x, x']. p0 is one less the
column's mean and p the levels' frequencies over the training rows, as the
reference's ``calculate_features`` sets them. The continuous dims are
``oak.dim_gram``'s orthogonal RBF under N(0, 1), and the OAK gram is
sum_n sigma2_n e_n over every dim's gram, by ``oak.elementary``'s product
expansion.

The program forms the categorical table on a factor (U - (U v) v^T / v^T v
with U = [W, diag(sqrt kappa)]) and the binary gram as an outer product;
here both are the published entrywise formulas above.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import oak


def binary_table(p0: torch.Tensor) -> torch.Tensor:
    p1 = 1.0 - p0
    return torch.stack([torch.stack([p1 * p1, -p0 * p1]), torch.stack([-p0 * p1, p0 * p0])])


def categorical_table(W: torch.Tensor, kappa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """B [C, C] for W [C, rank], kappa [C] (positive) and p [C]."""
    A = W @ W.T + torch.diag(kappa)
    Ap = A @ p
    return A - Ap[:, None] * Ap[None, :] / (p @ Ap)


def table_gram(B: torch.Tensor, x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """B[x_i, x2_j] at the level codes x [N], x2 [M]: [N, M]."""
    return B[x.long()][:, x2.long()]


def measures(X: torch.Tensor, binary: Sequence[int], categorical: Sequence[int]
             ) -> Dict[int, torch.Tensor]:
    """Each discrete dim's measure from the training rows X: p0 (a scalar)
    for a binary dim, the levels' frequencies [C] for a categorical one
    (codes 0..C-1, every level present)."""
    out = {d: 1.0 - X[:, d].mean() for d in binary}
    for d in categorical:
        counts = torch.bincount(X[:, d].long())
        out[d] = counts.to(X.dtype) / counts.sum()
    return out


def tables(leaves: Dict[str, torch.Tensor], kappa_of, binary: Sequence[int],
           categorical: Sequence[int], p: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """Every discrete dim's table: binary from its p0, categorical from the
    leaves ``W.<d>`` [C * rank] and ``kappa.<d>`` (``kappa_of`` maps the
    unconstrained value to the positive one)."""
    out = {d: binary_table(p[d]) for d in binary}
    for d in categorical:
        C = p[d].shape[0]
        out[d] = categorical_table(leaves[f"W.{d}"].reshape(C, -1), kappa_of(leaves[f"kappa.{d}"]),
                                   p[d])
    return out


def dim_grams(X: torch.Tensor, X2: torch.Tensor, ls: Dict[int, torch.Tensor],
              B: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
    """The grams of every dim: the orthogonal RBF for the dims of ``ls``
    (lengthscales), the table's entries for the dims of ``B``."""
    grams = [oak.dim_gram(X[:, d], X2[:, d], l) for d, l in ls.items()]
    grams += [table_gram(t, X[:, d], X2[:, d]) for d, t in B.items()]
    return grams


def dim_diags(X: torch.Tensor, ls: Dict[int, torch.Tensor], B: Dict[int, torch.Tensor]
              ) -> List[torch.Tensor]:
    diags = [oak.dim_diag(X[:, d], l) for d, l in ls.items()]
    diags += [torch.diagonal(t)[X[:, d].long()] for d, t in B.items()]
    return diags


def combine(parts: List[torch.Tensor], sig2: torch.Tensor) -> torch.Tensor:
    """sum_n sigma2_n e_n of the per-dim ``parts`` (grams or diagonals)."""
    e = oak.elementary(parts, sig2.shape[0] - 1)
    out = sig2[0] * torch.ones_like(parts[0])
    for n, en in enumerate(e, start=1):
        out = out + sig2[n] * en
    return out
