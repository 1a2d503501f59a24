"""The port's normalising flows (oak_tpu_torch.flows) and the bijectors'
log-det-Jacobians against oak_tpu at float64: forward, inverse,
forward_log_det_jacobian and the KL objective at equal parameters within
1e-12 relative; fit_normalizers' per-dim KL within 1e-10 relative and its
parameters within 1e-6; the flow{i} key paths load across packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.bijectors as jbij
import oak_tpu.checkpoint as jckpt
import oak_tpu.flows as jflows
from oak_tpu_torch import bijectors as tbij
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import flows as tflows

KW = dict(dtype=torch.float64, device="cpu")
EXACT, KL_REL, PARAM_TOL = 1e-12, 1e-10, 1e-6
FIELDS = ("skewness", "tailweight", "scale", "shift")


def _close(a, b, rel):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _columns(seed=0, n=150):
    """Three skewed positive columns and one symmetric one, each with a
    well-separated optimum of the flow's KL (a shifted exponential, say,
    puts it in a flat valley where scale and skewness trade off)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.lognormal(0.0, 0.8, n), rng.gamma(2.0, 1.5, n),
                     rng.chisquare(4, n), rng.normal(size=n)], axis=1)


BIJECTORS = [(jbij.Identity(), tbij.Identity()), (jbij.Softplus(), tbij.Softplus()),
             (jbij.Softplus(low=1e-3), tbij.Softplus(low=1e-3)), (jbij.Exp(), tbij.Exp()),
             (jbij.Sigmoid(low=1e-3, high=1e3), tbij.Sigmoid(low=1e-3, high=1e3))]


@pytest.mark.parametrize("pair", BIJECTORS, ids=lambda p: repr(p[1]))
def test_bijector_log_det_jacobian_matches_jax(pair):
    jb, tb = pair
    x = np.linspace(-30.0, 30.0, 61)
    _close(tb.forward_log_det_jacobian(torch.as_tensor(x)),
           jb.forward_log_det_jacobian(jnp.asarray(x)), EXACT)
    # and it is the log of the forward map's derivative
    xt = torch.as_tensor(np.linspace(-4.0, 4.0, 9), dtype=torch.float64).requires_grad_(True)
    (d,) = torch.autograd.grad(tb.forward(xt).sum(), xt)
    _close(tb.forward_log_det_jacobian(xt.detach()), torch.log(d), 1e-12)


def _pair(x, log, seed):
    """(jax Normalizer, port Normalizer) at the same raws: oak_tpu's create
    on x, its raws moved by seeded noise, bridged through its flow key
    paths into the port's."""
    jn = jflows.Normalizer.create(x, log=log, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    jn = jn.replace(**{f: getattr(jn, f).replace(
        raw=getattr(jn, f).raw + rng.normal(scale=0.3)) for f in FIELDS})
    data = jckpt._flat_with_keys(jn, "flow3")
    assert sorted(data) == ["flow3.offset"] + sorted(f"flow3.{f}.raw" for f in FIELDS)
    tn = tckpt.load_params(tflows.Normalizer.create(np.array([0.5, 1.0, 2.0]), log=log, **KW),
                           data, prefix="flow3")
    return jn, tn


@pytest.mark.parametrize("log", [True, False], ids=["log", "linear"])
def test_normalizer_matches_jax_at_equal_parameters(log):
    x = _columns()[:, 0]
    jn, tn = _pair(x, log, seed=4)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    y = tn.forward(xt)
    _close(y, jn.forward(xj), EXACT)
    _close(tn.inverse(y), jn.inverse(jnp.asarray(y.detach().numpy())), EXACT)
    _close(tn.inverse(y), x, 1e-10)
    _close(tn.forward_log_det_jacobian(xt), jn.forward_log_det_jacobian(xj), EXACT)
    _close(tn.kl_objective(xt), jn.kl_objective(xj), EXACT)
    _close(tn.KL_objective(x), jn.KL_objective(x), EXACT)


def test_log_cosh_does_not_overflow_in_float32():
    """The log-det at |g| far past float32's cosh overflow (~89) stays
    finite, as oak_tpu's does."""
    n = tflows.Normalizer.create(np.array([0.5, 1.0, 2.0]), log=False, dtype=torch.float32,
                                 device="cpu")
    n.tailweight.assign(40.0)
    out = n.forward_log_det_jacobian(torch.tensor([-50.0, 0.0, 50.0]))
    assert bool(torch.isfinite(out).all())


def test_create_matches_jax():
    x = _columns()[:, 1]
    for log in (True, False):
        jn = jflows.Normalizer.create(x, log=log, dtype=jnp.float64)
        tn = tflows.Normalizer.create(x, log=log, **KW)
        for f in FIELDS:
            _close(getattr(tn, f).raw, getattr(jn, f).raw, EXACT)
        _close(tn.offset, jn.offset, EXACT)
        assert tn.offset.shape == () and tn.skewness.raw.shape == ()


@pytest.fixture(scope="module")
def fitted():
    X = _columns(seed=1)
    return X, jflows.fit_normalizers(X, dtype=jnp.float64), tflows.fit_normalizers(X, **KW)


def test_fit_normalizers_matches_jax(fitted):
    X, jflist, tflist = fitted
    assert len(tflist) == len(jflist) == X.shape[1]
    for k, (jn, tn) in enumerate(zip(jflist, tflist)):
        _close(tn.kl_objective(torch.as_tensor(X[:, k])), jn.kl_objective(jnp.asarray(X[:, k])),
               KL_REL)
        for f in FIELDS:
            p = getattr(tn, f)
            assert p.raw.shape == ()
            assert p.bij == (tbij.Exp() if f in ("tailweight", "scale") else tbij.Identity())
            np.testing.assert_allclose(float(p.value.detach()), float(getattr(jn, f).value),
                                       atol=PARAM_TOL, rtol=PARAM_TOL)
        assert float(tn.offset) == float(jn.offset)


def test_fitted_flows_gaussianise(fitted):
    """The fitted flows move each column towards N(0, 1): the KS statistic
    falls below the identity's, and equals oak_tpu's kstest."""
    from scipy import stats

    X, jflist, tflist = fitted
    for k in range(3):  # the skewed columns
        ours = tflows.kstest(tflist[k], X[:, k])
        theirs = jflows.kstest(jflist[k], X[:, k])
        np.testing.assert_allclose(ours.statistic, theirs.statistic, rtol=1e-6)
        assert ours.statistic < stats.kstest(
            (X[:, k] - X[:, k].mean()) / X[:, k].std(), "norm").statistic


@pytest.mark.parametrize("optimizer", ["lbfgs", "scipy"])
def test_fit_normalizer_matches_jax(optimizer):
    x = _columns(seed=2)[:, 0]
    jn = jflows.fit_normalizer(x, dtype=jnp.float64, optimizer=optimizer)
    tn = tflows.fit_normalizer(x, optimizer=optimizer, **KW)
    _close(tn.kl_objective(torch.as_tensor(x)), jn.kl_objective(jnp.asarray(x)), KL_REL)
    for f in FIELDS:
        np.testing.assert_allclose(float(getattr(tn, f).value.detach()),
                                   float(getattr(jn, f).value),
                                   atol=PARAM_TOL, rtol=PARAM_TOL)


def test_stacked_normalizer_splits_into_scalar_flows(fitted):
    """fit_normalizers' K flows hold the stacked flow's entries: the port's
    stacked forward on [N, K] equals its K scalar forwards."""
    X, _, tflist = fitted
    stacked = tflows._stacked_normalizer(X, True, **KW)
    for f in FIELDS:
        getattr(stacked, f).raw.data = torch.stack([getattr(t, f).raw.detach()
                                                    for t in tflist])
    with torch.no_grad():
        Y = stacked.forward(torch.as_tensor(X))
        for k, t in enumerate(tflist):
            _close(Y[:, k], t.forward(torch.as_tensor(X[:, k])), EXACT)
