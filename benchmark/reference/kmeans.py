"""One Lloyd step of k-means (Lloyd, 1982), in numpy float64: each row to
its nearest centre, each centre to the mean of its rows, a centre left with
no row moved to the row farthest from its own centre.

``lloyd_gain`` judges centres that k-means claims to have converged: the
share by which one more step lowers their inertia (the summed squared
distance of each row to its nearest centre). Centres at a fixed point of
the step read 0; centres fitted to other rows, collapsed or duplicated
read far above it."""

from __future__ import annotations

import numpy as np


def _sq_dists(X: np.ndarray, C: np.ndarray) -> np.ndarray:
    return ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)


def inertia(X: np.ndarray, C: np.ndarray) -> float:
    return float(_sq_dists(X, C).min(1).sum())


def step(X: np.ndarray, C: np.ndarray) -> np.ndarray:
    """The centres after one Lloyd step from ``C`` [K, D] on the rows X [N, D]."""
    d = _sq_dists(X, C)
    labels = d.argmin(1)
    K = C.shape[0]
    counts = np.bincount(labels, minlength=K)
    out = np.zeros_like(C)
    np.add.at(out, labels, X)
    out /= np.maximum(counts, 1)[:, None]
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        far = np.argsort(d[np.arange(len(labels)), labels])[::-1][: len(empty)]
        out[empty] = X[far]
    return out


def lloyd_gain(X: np.ndarray, C: np.ndarray) -> float:
    """(inertia(C) - inertia(step(C))) / inertia(C) on the rows X."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    before = inertia(X, C)
    return (before - inertia(X, step(X, C))) / before
