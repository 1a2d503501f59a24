"""The port's oak_model (oak_tpu_torch.model) and its checkpoint against
oak_tpu's at float64, on small data (N = 120, D = 3, depth 2):

- ``fit(optimise=False)`` builds the same model: X_scaled, the flows and
  every parameter and buffer, for GPR, SGPR (sparse, inducing points the
  first rows; a binary column and an empirical measure) and the Bernoulli
  SVGP (a categorical column);
- ``fit`` with ``restarts=0`` and ``restarts=2`` reaches oak_tpu's training
  loss within 1e-6 relative (the converged loss, not the trajectory);
- an oak_tpu-saved oak_model loads into the port, and a port-saved one into
  oak_tpu: predict, NLL, Sobol and the per-component predictions agree
  within 1e-9;
- the retry after a bad L-BFGS fit starts from the untrained parameters;
- the validation errors of oak_tpu's fit and optimise are raised.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.model as jmodel
import oak_tpu.params as jp
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import model as tmodel
from oak_tpu_torch import params as tp

KW = dict(dtype=torch.float64, device="cpu")
REL, LOSS_REL, LOAD_REL = 1e-8, 1e-6, 1e-9
N, DEPTH = 120, 2


def _close(a, b, rel):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _data(kind, seed=0, n=N):
    """X [n, 3] with skewed positive columns (the flows have work to do) and
    y; "sgpr" makes column 2 binary, "bernoulli" makes it a 3-level code and
    draws 0/1 labels."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.lognormal(0.0, 0.5, n), rng.normal(size=n), rng.gamma(3.0, 1.0, n)], 1)
    f = np.sin(X[:, 1]) + 0.3 * np.log(X[:, 0]) * X[:, 2]
    if kind == "sgpr":
        X[:, 2] = (X[:, 2] > 2.5).astype(float)
    if kind == "bernoulli":
        X[:, 2] = np.minimum(np.floor(X[:, 2] / 2.0), 2.0)
        return X, (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-3.0 * f))).astype(float)
    return X, f + 0.1 * rng.normal(size=n)


CONFIGS = {
    "gpr": dict(),
    "sgpr": dict(sparse=True, num_inducing=20, binary_feature=[2], empirical_measure=[1]),
    "bernoulli": dict(likelihood="bernoulli", num_inducing=20, categorical_feature=[2]),
}


def _built(kind):
    X, y = _data(kind)
    cfg = dict(max_interaction_depth=DEPTH, **CONFIGS[kind])
    j = jmodel.oak_model(**cfg).fit(X, y, optimise=False, initialise_inducing_points=False)
    t = tmodel.oak_model(**cfg, **KW).fit(X, y, optimise=False,
                                          initialise_inducing_points=False)
    return j, t, X, y


_BUILT = {}


def _cached(kind):
    if kind not in _BUILT:
        _BUILT[kind] = (kind,) + _built(kind)
    return _BUILT[kind]


@pytest.fixture(params=list(CONFIGS))
def built(request):
    return _cached(request.param)


def test_fit_without_optimising_builds_the_same_model(built):
    kind, j, t, X, y = built
    assert type(t.m).__name__ == {"gpr": "GPR", "sgpr": "SGPR", "bernoulli": "SVGP"}[kind]
    assert (t.continuous_index, t.binary_index, t.categorical_index) == \
        (j.continuous_index, j.binary_index, j.categorical_index)
    _close(t.X_scaled, j.X_scaled, REL)
    _close(t.Y_scaled, j.Y_scaled, REL)
    for jf, tf in zip(j.input_flows, t.input_flows):
        assert (jf is None) == (tf is None)
        if tf is not None:
            for key, arr in jckpt._flat_with_keys(jf, "f").items():
                _close(tckpt._arrays(tf, "f")[key], arr, REL)
    jarrays, tarrays = jckpt._flat_with_keys(j.m, "m"), tckpt._arrays(t.m, "m")
    assert sorted(tarrays) == sorted(jarrays)
    for key, arr in jarrays.items():
        if key.endswith(".W.raw"):
            # a categorical kernel's W ~ U[0, 1) comes from each package's
            # own generator (jax.random key 0, torch.Generator seed 0)
            assert tarrays[key].shape == arr.shape
            assert ((tarrays[key] >= 0) & (tarrays[key] < 1)).all()
        else:
            _close(tarrays[key], arr, REL)
    # at oak_tpu's W as well: the same loss and the same parameter table
    t = copy.deepcopy(t)
    tckpt.load_params(t.m, jarrays)
    with torch.no_grad():
        assert float(t._loss_fn()(t.m)) == pytest.approx(float(j._loss_fn()(j.m)), rel=REL)
    assert t.summary() == j.summary()


def _trained_pair(restarts):
    X, y = _data("gpr")
    j = jmodel.oak_model(max_interaction_depth=DEPTH).fit(X, y, restarts=restarts)
    t = tmodel.oak_model(max_interaction_depth=DEPTH, **KW).fit(X, y, restarts=restarts)
    return j, t


@pytest.fixture(scope="module", params=[0, 2], ids=["single_start", "restarts_2"])
def trained(request):
    return _trained_pair(request.param)


def test_fit_reaches_the_jax_training_loss(trained):
    j, t = trained
    with torch.no_grad():
        ours = float(t.m.training_loss())
    assert ours == pytest.approx(float(j.m.training_loss()), rel=LOSS_REL)
    assert np.isfinite(ours) and t.timings["optimise"] > 0


def _perturb_jax_q(j):
    """Seeded q_mu so an untrained SVGP predicts something."""
    m = j.m
    rng = np.random.default_rng(5)
    j.m = m.replace(q_mu=m.q_mu.replace(raw=jnp.asarray(rng.normal(size=m.q_mu.raw.shape))))
    return j


def _agree(a, b, X, rel=LOAD_REL):
    """predict, the NLL, Sobol and the per-component predictions of two
    oak_models (either package) at the rows X."""
    _close(a.predict(X), b.predict(X), rel)
    y = b.predict(X) + 0.1
    assert a.get_loglik(X, y) == pytest.approx(b.get_loglik(X, y), rel=rel)
    _close(a.get_sobol(), b.get_sobol(), rel)
    assert [tuple(t) for t in a.tuple_of_indices] == [tuple(t) for t in b.tuple_of_indices]
    _close(a.get_prediction_components(X), b.get_prediction_components(X), rel)
    if a.likelihood == "bernoulli":
        _close(a.predict_proba(X), b.predict_proba(X), rel)


def test_jax_saved_model_loads_into_the_port(tmp_path, built):
    kind, j, _, X, _ = built
    j = _perturb_jax_q(copy.copy(j)) if kind == "bernoulli" else j
    path = tmp_path / "jax_model.npz"
    jckpt.save_oak_model(j, path)
    t = tckpt.load_oak_model(path, **KW)
    assert {p.dtype for p in t.m.parameters()} == {torch.float64}
    _agree(t, j, X[:40])
    # and the port's own save is what oak_tpu wrote, key for key
    again = tmp_path / "port_model.npz"
    t.save(again)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if key != "config":
                _close(b[key], a[key], 0.0)


def test_port_saved_model_loads_into_jax(tmp_path, trained):
    j, t = trained
    path = tmp_path / "port_model.npz"
    tckpt.save_oak_model(t, path)
    _agree(jckpt.load_oak_model(path), t, _data("gpr", seed=3)[0][:40])
    # and back: the port reloads its own file to the same numbers
    _agree(tmodel.oak_model.load(path, **KW), t, _data("gpr", seed=3)[0][:40], rel=1e-12)


def test_retry_starts_from_the_untrained_parameters(monkeypatch):
    """A single L-BFGS fit judged degenerate is retried by a 2-start
    multistart from the model as it was before the fit, not from the
    trained one (the port's fits write in place)."""
    X, y = _data("gpr")
    t = tmodel.oak_model(max_interaction_depth=DEPTH, **KW).fit(X, y, optimise=False)
    untrained = tp.flatten_trainable(t.m).detach().clone()
    monkeypatch.setattr(tmodel.oak_model, "_degenerate_noise_fit", staticmethod(lambda m: True))
    calls = []
    real = tmodel.fit_lbfgs_multistart

    def spy(model, *args, **kwargs):
        calls.append((model, tp.flatten_trainable(model).detach().clone(), kwargs))
        return real(model, *args, **kwargs)

    monkeypatch.setattr(tmodel, "fit_lbfgs_multistart", spy)
    res = t.optimise(max_iters=5)
    (model, start, kwargs), = calls
    assert torch.equal(start, untrained)
    assert kwargs["n_starts"] == 2 and kwargs["warm_adam_steps"] == 300
    assert not kwargs["include_init"]
    assert t.m is res.model and np.isfinite(res.fun)


@pytest.mark.parametrize("sparse", [False, True], ids=["gpr", "sgpr"])
def test_create_model_oak_matches_jax(sparse):
    """create_model_oak builds oak_tpu's GPR, or SGPR on given inducing
    points, and with optimise=True reaches its L-BFGS loss."""
    X, y = _data("gpr", seed=4, n=60)
    X = (X - X.mean(0)) / X.std(0)
    y = ((y - y.mean()) / y.std()).reshape(-1, 1)
    kw = dict(max_interaction_depth=DEPTH, inducing_pts=X[:15] if sparse else None,
              optimise=True)
    j = jmodel.create_model_oak((X, y), **kw)
    t = tmodel.create_model_oak((X, y), **kw, **KW)
    assert type(t).__name__ == type(j).__name__ == ("SGPR" if sparse else "GPR")
    with torch.no_grad():
        assert float(t.training_loss()) == pytest.approx(float(j.training_loss()),
                                                         rel=LOSS_REL)


def test_validation_errors_are_raised():
    X, y = _data("sgpr")
    with pytest.raises(ValueError, match="Empirical measure"):
        tmodel.oak_model(binary_feature=[2], empirical_measure=[2], **KW).fit(X, y)
    with pytest.raises(ValueError, match="number of GMM components"):
        tmodel.oak_model(gmm_measure=[1, 0], **KW).fit(X, y)
    with pytest.raises(ValueError, match="GMM measure on inputs"):
        tmodel.oak_model(binary_feature=[2], gmm_measure=[0, 0, 2], **KW).fit(X, y)
    with pytest.raises(ValueError, match="Overlapping"):
        tmodel.oak_model(binary_feature=[2], categorical_feature=[2], **KW).fit(X, y)
    gpr = tmodel.oak_model(optimizer="scipy", **KW).fit(*_data("gpr"), optimise=False)
    with pytest.raises(ValueError, match="restarts > 0"):
        gpr.optimise(restarts=2)
    with pytest.raises(ValueError, match="checkpoint_path"):
        gpr.optimise(checkpoint_path="unused.npz")
    gpr.optimizer = "natgrad"
    with pytest.raises(ValueError, match="requires an SVGP"):
        gpr.optimise()
    with pytest.raises(ValueError, match="minibatch training requires"):
        gpr.optimise_minibatch()
    with pytest.raises(ValueError, match="outside the range"):
        gpr.predict(np.full((2, 3), -1e3))


def test_gmm_measure_model_builds_and_trains():
    """A GMM measure (estimated by the port's EM) takes its dim out of the
    flows; the model trains to a finite loss."""
    X, y = _data("gpr")
    t = tmodel.oak_model(max_interaction_depth=DEPTH, gmm_measure=[0, 2, 0], **KW)
    t.fit(X, y, optimise=False)
    assert t.input_flows[1] is None and t.estimated_gmm_measures[1] is not None
    assert t._get_x_inverse_transformer(1) is None
    res = t.optimise(max_iters=20)
    assert np.isfinite(res.fun)


def test_scipy_optimizer_matches_jax():
    X, y = _data("gpr")
    j = jmodel.oak_model(max_interaction_depth=DEPTH, optimizer="scipy").fit(X, y)
    t = tmodel.oak_model(max_interaction_depth=DEPTH, optimizer="scipy", **KW).fit(X, y)
    with torch.no_grad():
        assert float(t.m.training_loss()) == pytest.approx(float(j.m.training_loss()),
                                                           rel=LOSS_REL)


def test_minibatch_and_samples_on_the_bernoulli_model():
    """optimise_minibatch draws oak_tpu's index stream, so a few Adam steps
    land where oak_tpu's do; the draws are probabilities of the right
    shape; the inverse transformer undoes the flow."""
    _, j, t, X, _ = _cached("bernoulli")
    j, t = copy.copy(j), copy.deepcopy(t)
    tckpt.load_params(t.m, jckpt._flat_with_keys(j.m, "m"))  # oak_tpu's categorical W
    jres = j.optimise_minibatch(batch_size=32, steps=5)
    res = t.optimise_minibatch(batch_size=32, steps=5)
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    _close(tp.flatten_trainable(t.m), jp.flatten_trainable(j.m)[0], REL)
    draws = t.predict_f_samples(X[:10], num_samples=3)
    assert draws.shape == (3, 10) and ((draws >= 0) & (draws <= 1)).all()
    inv = t._get_x_inverse_transformer(0)
    _close(inv(t.X_scaled[:10, 0]), X[:10, 0], 1e-10)
    np.testing.assert_allclose(t.get_sobol_by_order(), j.get_sobol_by_order(), rtol=1e-6,
                               atol=1e-12)
