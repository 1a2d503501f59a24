"""Inputs made from a run's seed, in numpy, so that the program and the
reference are handed the same arrays."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use (``stream``) of one seed; any
    whole number is a seed."""
    return np.random.default_rng([stream, seed % 2 ** 64])


def synth_pumadyn(n: int, d: int, gen: np.random.Generator):
    """pumadyn's shapes with a synthetic response (the UCI files are not in
    the repository): X ~ N(0, I), y = tanh(X w) + x_0 x_1 / 2 + noise 0.1,
    in float32, y as [n]."""
    X = gen.normal(size=(n, d))
    w = gen.normal(size=d) / np.sqrt(d)
    y = np.tanh(X @ w) + 0.5 * X[:, 0] * X[:, 1] + 0.1 * gen.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)
