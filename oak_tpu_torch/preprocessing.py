"""Input preprocessing (``oak_tpu.preprocessing``): scalers, feature
classification, k-means inducing-point initialisation, 1-D Gaussian-mixture
measures and empirical measures from unique values.

These run once per fit on small host data, in numpy, as ``oak_tpu`` runs
them. ``oak_tpu`` calls scikit-learn for k-means and the mixture; the port
does not depend on it, so ``kmeans`` (k-means++ seeding and Lloyd
iterations) and ``estimate_one_dim_gmm`` (EM on a spherical mixture) are
written here with scikit-learn's defaults. They cannot match it bit for bit,
since its random streams are its own; the tests bound their quality against
it instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .measures import MOGMeasure


@dataclasses.dataclass
class StandardScaler:
    """Minimal sklearn.preprocessing.StandardScaler equivalent (fit/transform/
    inverse_transform on [N, D] numpy arrays)."""

    mean_: np.ndarray = None
    scale_: np.ndarray = None

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, np.float64) - self.mean_) / self.scale_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float64) * self.scale_ + self.mean_

    @property
    def var_(self) -> np.ndarray:
        return self.scale_ ** 2


# --------------------------------------------------------------------------- #
# k-means
# --------------------------------------------------------------------------- #
def _sq_dists(X: np.ndarray, C: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Squared distances [N, K] of the rows of X to the rows of C (x2 holds
    the rows' squared norms)."""
    d = x2[:, None] - 2.0 * (X @ C.T) + np.sum(C * C, axis=1)[None, :]
    return np.maximum(d, 0.0)


def _kmeans_plusplus(X: np.ndarray, K: int, x2: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Greedy k-means++ seeding: each new centre is the best of
    2 + log(K) candidates drawn with probability proportional to the squared
    distance to the nearest centre so far."""
    n = X.shape[0]
    trials = 2 + int(np.log(K))
    centres = np.empty((K, X.shape[1]))
    centres[0] = X[rng.integers(n)]
    closest = _sq_dists(X, centres[:1], x2)[:, 0]
    pot = closest.sum()
    for c in range(1, K):
        ids = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * pot)
        ids = np.clip(ids, None, n - 1)
        cand = np.minimum(closest[None, :], _sq_dists(X, X[ids], x2).T)
        best = int(np.argmin(cand.sum(axis=1)))
        closest, pot = cand[best], cand[best].sum()
        centres[c] = X[ids[best]]
    return centres


def _update_centres(X: np.ndarray, labels: np.ndarray, dist: np.ndarray,
                    K: int) -> np.ndarray:
    """Means of the clusters; an empty cluster moves to a point far from its
    own centre (the farthest points first, as scikit-learn relocates)."""
    counts = np.bincount(labels, minlength=K)
    sums = np.stack([np.bincount(labels, weights=X[:, d], minlength=K)
                     for d in range(X.shape[1])], axis=1)
    centres = sums / np.maximum(counts, 1)[:, None]
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        far = np.argsort(dist[np.arange(len(labels)), labels])[::-1][:len(empty)]
        centres[empty] = X[far]
    return centres


def _lloyd(X: np.ndarray, centres: np.ndarray, x2: np.ndarray, max_iter: int,
           tol: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lloyd iterations until the labels stop changing or the summed squared
    centre shift is at most ``tol``; returns (centres, labels, inertia), the
    labels and inertia of the returned centres."""
    K = centres.shape[0]
    labels = None
    for _ in range(max_iter):
        dist = _sq_dists(X, centres, x2)
        new_labels = np.argmin(dist, axis=1)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        new = _update_centres(X, labels, dist, K)
        shift = float(np.sum((new - centres) ** 2))
        centres = new
        if shift <= tol:
            break
    dist = _sq_dists(X, centres, x2)
    labels = np.argmin(dist, axis=1)
    return centres, labels, float(dist[np.arange(len(labels)), labels].sum())


def kmeans(X: np.ndarray, K: int, seed: int = 0, n_init: int = 10,
           max_iter: int = 300, tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centres [K, D], labels [N], inertia): k-means with scikit-learn's
    defaults: ``n_init`` k-means++ seedings, each refined by Lloyd
    iterations (at most ``max_iter``, stopping when the summed squared centre
    shift is at most ``tol`` times the data's mean per-feature variance), the
    best inertia kept. Every draw comes from ``default_rng(seed)``."""
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if not 1 <= K <= X.shape[0]:
        raise ValueError(f"n_clusters={K} must be between 1 and the {X.shape[0]} samples")
    rng = np.random.default_rng(seed)
    x2 = np.sum(X * X, axis=1)
    tol_abs = tol * float(np.mean(np.var(X, axis=0)))
    best = None
    for _ in range(n_init):
        out = _lloyd(X, _kmeans_plusplus(X, K, x2, rng), x2, max_iter, tol_abs)
        if best is None or out[2] < best[2]:
            best = out
    return best


def get_kmeans_centers(X: np.ndarray, K: int = 500, seed: int = 0) -> np.ndarray:
    """K-means inducing init (``oak_tpu``: sklearn KMeans(n_init=10,
    random_state=seed))."""
    return kmeans(X, K, seed=seed)[0]


def _discrete_centers(col: np.ndarray, n_clusters: int) -> np.ndarray:
    """Inducing-point coordinates for a discrete (binary/categorical) column:
    the observed level codes, allocated proportionally to their observed
    frequencies (largest-remainder rounding; every observed level gets at
    least one slot when it fits). ``oak_tpu``'s docstring says why this
    replaces the reference's per-column k-means."""
    vals, counts = np.unique(col, return_counts=True)
    if len(vals) >= n_clusters:
        return vals[np.argsort(counts)[::-1][:n_clusters]]
    frac = counts / counts.sum() * n_clusters
    quota = np.maximum(np.floor(frac).astype(int), 1)
    rem = np.argsort(frac - np.floor(frac))[::-1]
    for i in np.tile(rem, n_clusters):  # largest remainders first
        if quota.sum() >= n_clusters:
            break
        quota[i] += 1
    while quota.sum() > n_clusters:  # only when the >=1 floor overshot
        quota[np.argmax(quota)] -= 1
    return np.repeat(vals, quota)


def initialize_kmeans_with_binary(
    X: np.ndarray, binary_index: Sequence[int],
    continuous_index: Optional[Sequence[int]] = None, n_clusters: int = 200,
) -> np.ndarray:
    """Frequency-proportional codes on each binary column, joint k-means on
    the continuous block."""
    Z = np.zeros((n_clusters, X.shape[1]))
    for idx in binary_index:
        Z[:, idx] = _discrete_centers(X[:, idx], n_clusters)
    if continuous_index is not None and len(continuous_index):
        Z[:, list(continuous_index)] = kmeans(X[:, list(continuous_index)], n_clusters,
                                              seed=0)[0]
    return Z


def initialize_kmeans_with_categorical(
    X: np.ndarray, binary_index: Sequence[int], categorical_index: Sequence[int],
    continuous_index: Sequence[int], n_clusters: int = 200,
) -> np.ndarray:
    """Frequency-proportional codes on each binary and categorical column,
    joint k-means on the continuous block."""
    Z = np.zeros((n_clusters, X.shape[1]))
    for idx in list(binary_index) + list(categorical_index):
        Z[:, idx] = _discrete_centers(X[:, idx], n_clusters)
    if len(continuous_index):
        Z[:, list(continuous_index)] = kmeans(X[:, list(continuous_index)], n_clusters,
                                              seed=0)[0]
    return Z


# --------------------------------------------------------------------------- #
# 1-D Gaussian mixture
# --------------------------------------------------------------------------- #
_LOG2PI = np.log(2.0 * np.pi)


def _gmm_m_step(x: np.ndarray, resp: np.ndarray, reg_covar: float):
    """(weights, means, variances) of a 1-D mixture from responsibilities
    [N, K], scikit-learn's spherical estimate."""
    nk = resp.sum(axis=0) + 10.0 * np.finfo(resp.dtype).eps
    means = resp.T @ x / nk
    variances = resp.T @ (x * x) / nk - 2.0 * means * (resp.T @ x / nk) + means ** 2 \
        + reg_covar
    return nk / len(x), means, variances


def _gmm_log_prob(x: np.ndarray, weights, means, variances) -> np.ndarray:
    """log (w_k N(x_n | mu_k, var_k)), [N, K]."""
    return (-0.5 * (_LOG2PI + np.log(variances)[None, :]
                    + (x[:, None] - means[None, :]) ** 2 / variances[None, :])
            + np.log(weights)[None, :])


def gmm_mean_log_likelihood(x: np.ndarray, weights, means, variances) -> float:
    """The mean log-likelihood of the 1-D samples x under the mixture."""
    lp = _gmm_log_prob(np.asarray(x, np.float64).reshape(-1), np.asarray(weights),
                       np.asarray(means), np.asarray(variances))
    top = lp.max(axis=1, keepdims=True)
    return float(np.mean(top[:, 0] + np.log(np.exp(lp - top).sum(axis=1))))


def fit_one_dim_gmm(x: np.ndarray, K: int, seed: int = 0, reg_covar: float = 1e-6,
                    tol: float = 1e-3, max_iter: int = 100
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(weights, means, variances) of a K-component mixture fitted to the
    1-D samples x by EM with scikit-learn's GaussianMixture defaults: the
    responsibilities start from one k-means run (seeded by ``seed``), and
    the iterations stop once the mean log-likelihood changes by less than
    ``tol``."""
    x = np.asarray(x, np.float64).reshape(-1)
    labels = kmeans(x, K, seed=seed, n_init=1)[1]
    resp = np.zeros((len(x), K))
    resp[np.arange(len(x)), labels] = 1.0
    weights, means, variances = _gmm_m_step(x, resp, reg_covar)
    lower = -np.inf
    for _ in range(max_iter):
        lp = _gmm_log_prob(x, weights, means, variances)
        top = lp.max(axis=1, keepdims=True)
        norm = top + np.log(np.exp(lp - top).sum(axis=1, keepdims=True))
        weights, means, variances = _gmm_m_step(x, np.exp(lp - norm), reg_covar)
        prev, lower = lower, float(np.mean(norm))
        if abs(lower - prev) < tol:
            break
    return weights / weights.sum(), means, variances


def estimate_one_dim_gmm(K: int, X: np.ndarray, dtype: Optional[torch.dtype] = None,
                         device=None) -> MOGMeasure:
    """Spherical-GMM measure of one continuous dim (``oak_tpu``: sklearn
    GaussianMixture(covariance_type="spherical", random_state=0)), as a
    ``MOGMeasure`` in ``dtype`` on ``device`` (``config.resolve``)."""
    if K <= 0:
        raise ValueError("GMM needs K > 0 components")
    weights, means, variances = fit_one_dim_gmm(X, K)
    return MOGMeasure.create(means=means, variances=variances, weights=weights,
                             dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Feature classification, empirical measures
# --------------------------------------------------------------------------- #
def calculate_features(
    X: np.ndarray,
    categorical_feature: Optional[Sequence[int]],
    binary_feature: Optional[Sequence[int]],
) -> Tuple[List[int], List[int], List[int], Optional[list], Optional[list]]:
    """Classify feature columns and estimate discrete measure probabilities:
    binary p0 = 1 - mean(x); categorical p from observed frequencies."""
    D = X.shape[1]
    if binary_feature is None and categorical_feature is None:
        return list(range(D)), [], [], None, None
    if binary_feature is not None and categorical_feature is not None:
        overlap = set(binary_feature) & set(categorical_feature)
        if overlap:
            raise ValueError(f"Overlapping feature set {overlap}")
    binary_index, categorical_index, continuous_index = [], [], []
    p0: list = []
    p: list = []
    for j in range(D):
        if binary_feature is not None and j in binary_feature:
            p0.append(1.0 - X[:, j].mean())
            p.append(None)
            binary_index.append(j)
        elif categorical_feature is not None and j in categorical_feature:
            p0.append(None)
            values, counts = np.unique(X[:, j], return_counts=True)
            probs = (counts / counts.sum()).reshape(-1, 1)
            if not np.isclose(probs.sum(), 1.0, atol=1e-6):
                raise ValueError("categorical probabilities do not normalize")
            p.append(probs)
            categorical_index.append(j)
        else:
            p0.append(None)
            p.append(None)
            continuous_index.append(j)
    return continuous_index, binary_index, categorical_index, p0, p


def empirical_measure_from_column(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique values and their frequencies, as ([M, 1], [M, 1])."""
    locations, counts = np.unique(np.asarray(x).reshape(-1), return_counts=True)
    weights = (counts / counts.sum()).reshape(-1, 1)
    return locations.reshape(-1, 1), weights
