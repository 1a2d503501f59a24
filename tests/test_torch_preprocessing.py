"""The port's preprocessing (oak_tpu_torch.preprocessing) against
oak_tpu.preprocessing: the deterministic parts (scalers, feature
classification, empirical measures, discrete inducing codes) exactly equal;
k-means and the 1-D Gaussian mixture, which oak_tpu takes from scikit-learn
and the port writes itself, bounded in quality against scikit-learn: k-means
inertia at most 1.02 times scikit-learn's, the mixture's mean log-likelihood
within 1e-3 of scikit-learn's."""

import numpy as np
import pytest
import torch

import oak_tpu.preprocessing as jpre
from oak_tpu_torch import preprocessing as tpre
from oak_tpu_torch.measures import MOGMeasure

KW = dict(dtype=torch.float64, device="cpu")
INERTIA_RATIO, GMM_LL_TOL = 1.02, 1e-3


def _mixed(seed=0, n=150):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[:, 1] = (X[:, 1] > 0.3).astype(float)
    X[:, 2] = rng.integers(0, 3, size=n).astype(float)
    return X


def test_standard_scaler_equal():
    X = np.random.default_rng(1).normal(size=(50, 3)) * [1.0, 3.0, 0.0] + 2.0
    j, t = jpre.StandardScaler().fit(X), tpre.StandardScaler().fit(X)
    np.testing.assert_array_equal(t.mean_, j.mean_)
    np.testing.assert_array_equal(t.scale_, j.scale_)
    np.testing.assert_array_equal(t.transform(X), j.transform(X))
    np.testing.assert_array_equal(t.inverse_transform(X), j.inverse_transform(X))
    np.testing.assert_array_equal(t.var_, j.var_)


@pytest.mark.parametrize("categorical, binary", [(None, None), (None, [1]), ([2], [1]),
                                                 ([2], None)])
def test_calculate_features_equal(categorical, binary):
    X = _mixed()
    jout = jpre.calculate_features(X, categorical, binary)
    tout = tpre.calculate_features(X, categorical, binary)
    for a, b in zip(tout[:3], jout[:3]):
        assert a == b
    for a, b in zip(tout[3:], jout[3:]):
        if b is None:
            assert a is None
            continue
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)


def test_calculate_features_overlap_raises():
    with pytest.raises(ValueError, match="Overlapping"):
        tpre.calculate_features(_mixed(), [1], [1])


def test_empirical_measure_equal():
    x = np.round(np.random.default_rng(2).normal(size=80), 1)
    for a, b in zip(tpre.empirical_measure_from_column(x),
                    jpre.empirical_measure_from_column(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_clusters", [1, 2, 5, 40])
def test_discrete_centers_equal(n_clusters):
    col = _mixed()[:, 2]
    np.testing.assert_array_equal(tpre._discrete_centers(col, n_clusters),
                                  jpre._discrete_centers(col, n_clusters))


def _inertia(X, C):
    d = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    return float(d.min(axis=1).sum())


@pytest.mark.parametrize("n, d, k", [(200, 3, 20), (150, 4, 10), (120, 2, 3), (60, 4, 60)])
def test_kmeans_inertia_against_sklearn(n, d, k):
    KMeans = pytest.importorskip("sklearn.cluster").KMeans
    X = np.random.default_rng(n + d + k).normal(size=(n, d))
    ours = tpre.get_kmeans_centers(X, k)
    # neither random stream is the answer: scikit-learn's inertia is its
    # median over five seeds, so one lucky draw of its own sets no bound
    theirs = np.median([KMeans(n_clusters=k, random_state=s, n_init=10).fit(X).inertia_
                        for s in range(5)])
    assert ours.shape == (k, d)
    assert _inertia(X, ours) <= INERTIA_RATIO * theirs + 1e-12
    # the returned inertia is that of the returned centres
    c, labels, inertia = tpre.kmeans(X, k)
    # (the expanded distances of kmeans leave ~1e-15 where k = n)
    np.testing.assert_allclose(inertia, _inertia(X, c), rtol=1e-10, atol=1e-12)
    assert labels.shape == (n,) and set(labels) <= set(range(k))


def test_kmeans_is_seeded():
    X = np.random.default_rng(5).normal(size=(100, 3))
    np.testing.assert_array_equal(tpre.get_kmeans_centers(X, 7, seed=3),
                                  tpre.get_kmeans_centers(X, 7, seed=3))


def test_initialize_kmeans_with_categorical_and_binary():
    KMeans = pytest.importorskip("sklearn.cluster").KMeans
    X = _mixed(n=120)
    kw = dict(binary_index=[1], categorical_index=[2], continuous_index=[0, 3],
              n_clusters=12)
    ours, theirs = (m.initialize_kmeans_with_categorical(X, **kw) for m in (tpre, jpre))
    np.testing.assert_array_equal(ours[:, [1, 2]], theirs[:, [1, 2]])
    ref = KMeans(n_clusters=12, random_state=0, n_init=10).fit(X[:, [0, 3]])
    assert _inertia(X[:, [0, 3]], ours[:, [0, 3]]) <= INERTIA_RATIO * ref.inertia_
    ours_b = tpre.initialize_kmeans_with_binary(X, [1], [0, 3], n_clusters=12)
    theirs_b = jpre.initialize_kmeans_with_binary(X, [1], [0, 3], n_clusters=12)
    np.testing.assert_array_equal(ours_b[:, 1], theirs_b[:, 1])
    np.testing.assert_array_equal(ours_b[:, [0, 3]], ours[:, [0, 3]])


def _mixture_sample(K, seed):
    rng = np.random.default_rng(seed)
    means = np.array([-3.0, 0.5, 4.0])[:K]
    sds = np.array([0.6, 0.3, 1.0])[:K]
    sizes = np.array([90, 60, 50])[:K]
    return np.concatenate([rng.normal(m, s, size=n) for m, s, n in zip(means, sds, sizes)])


@pytest.mark.parametrize("K", [1, 2, 3])
def test_gmm_log_likelihood_against_sklearn(K):
    GaussianMixture = pytest.importorskip("sklearn.mixture").GaussianMixture
    x = _mixture_sample(K, seed=K)
    gm = GaussianMixture(n_components=K, random_state=0,
                         covariance_type="spherical").fit(x[:, None])
    w, m, v = tpre.fit_one_dim_gmm(x, K)
    ours = tpre.gmm_mean_log_likelihood(x, w, m, v)
    assert abs(ours - gm.score(x[:, None])) < GMM_LL_TOL
    np.testing.assert_allclose(np.sort(m), np.sort(gm.means_.ravel()), atol=1e-2)


def test_estimate_one_dim_gmm_builds_the_measure():
    x = _mixture_sample(2, seed=9)
    meas = tpre.estimate_one_dim_gmm(2, x, **KW)
    assert isinstance(meas, MOGMeasure)
    assert meas.means.dtype == torch.float64 and meas.means.shape == (2,)
    assert abs(float(meas.weights.sum()) - 1.0) < 1e-12
    assert bool((meas.variances > 0).all())
    with pytest.raises(ValueError, match="K > 0"):
        tpre.estimate_one_dim_gmm(0, x, **KW)
