"""The port's L-BFGS (oak_tpu_torch.optim.fit: the two-loop direction, the
zoom linesearch, the value-and-gradient reuse, the stopping rule) and
fit_scipy against oak_tpu's optax L-BFGS and scipy bridge at float64, on a
small GPR (N = 40, D = 4, depth 2) and on the flows' stacked KL: the first
5 iterates within 1e-8 of the largest magnitude, the converged loss within
1e-9 relative, both converged. Also the chunked checkpoint: a resumed run
follows the uninterrupted trajectory exactly."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.flows as jflows
import oak_tpu.optim.fit as jfit
import oak_tpu.params as jp
from oak_tpu_torch import flows as tflows
from oak_tpu_torch import params as tp
from oak_tpu_torch.optim import fit as tfit
from tests.test_torch_flows import _columns
from tests.test_torch_regression import regression_pair

KW = dict(dtype=torch.float64, device="cpu")
ITER_REL, LOSS_REL, FIRST = 1e-8, 1e-9, 5


def _close(a, b, rel):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _gpr():
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        jm, tm, _, _ = regression_pair(Path(d), "gpr")
    return jm, tm, lambda m: m.training_loss(), lambda m: m.training_loss()


def _flows():
    X = _columns(seed=1)
    jn = jflows._stacked_normalizer(X, True, jnp.float64)
    tn = tflows._stacked_normalizer(X, True, **KW)
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    return jn, tn, lambda m: m.kl_objective(Xj), lambda m: m.kl_objective(Xt)


PROBLEMS = {"gpr": _gpr, "flows_kl": _flows}


@pytest.fixture(scope="module", params=list(PROBLEMS))
def problem(request):
    """(jax model, port model, jax loss, port loss, oak_tpu's first
    iterates, oak_tpu's converged fit)."""
    jm, tm, jloss, tloss = PROBLEMS[request.param]()
    vec, unflatten = jp.flatten_trainable(jm)
    init, run_range, _ = jfit.lbfgs_parts(lambda v: jloss(unflatten(v)), 1e-8, 30)
    run = jax.jit(run_range)
    state, it, iterates = init(vec), 0, []
    for limit in range(1, FIRST + 1):
        vec, state, it = run(vec, state, it, limit)
        iterates.append(np.asarray(vec))
    return jm, tm, jloss, tloss, iterates, jfit.fit_lbfgs(jm, jloss, max_iters=300)


def test_first_iterates_match_optax(problem):
    _, tm, _, tloss, iterates, _ = problem
    init, run_range, stats = tfit.lbfgs_parts(
        lambda v: tfit.value_and_grad(tm, tloss, v), 1e-8, 30)
    vec = tp.flatten_trainable(tm).detach()
    state, it = init(vec), 0
    for limit, ref in enumerate(iterates, start=1):
        vec, state, it = run_range(vec, state, it, limit)
        assert it == limit
        _close(vec, ref, ITER_REL)
    value, grad = stats(state)
    assert np.isfinite(value) and grad.shape == vec.shape


def test_converged_loss_matches_optax(problem):
    _, tm, _, tloss, _, jres = problem
    model = copy.deepcopy(tm)
    res = tfit.fit_lbfgs(model, tloss, max_iters=300)
    assert res.model is model
    assert res.success and jres.success, (res.message, jres.message)
    assert res.fun == pytest.approx(jres.fun, rel=LOSS_REL)
    assert res.grad_norm <= 1e-8
    # the loss of the vector written into the model is the returned one
    with torch.no_grad():
        assert float(tloss(model)) == pytest.approx(res.fun, rel=1e-12)
    # lbfgs_loop, the single-call form, runs the same iterations
    run = tfit.lbfgs_loop(lambda v: tfit.value_and_grad(tm, tloss, v), 300, 1e-8)
    vec, value, grad, it = run(tp.flatten_trainable(tm).detach())
    assert it == res.num_iters and value == res.fun
    assert torch.equal(vec, tp.flatten_trainable(model)) and grad.shape == vec.shape


def test_checkpoint_resume_follows_the_uninterrupted_run(tmp_path):
    _, tm, _, tloss = _gpr()
    path = tmp_path / "lbfgs.npz"
    whole = tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=9)
    # a run killed after 4 iterations (two chunks of 2), then resumed to 9
    part = tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=4, checkpoint_path=path,
                          checkpoint_every=2)
    assert part.num_iters == 4 and path.exists()
    resumed = tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=9,
                             checkpoint_path=path, checkpoint_every=2)
    assert resumed.num_iters == whole.num_iters == 9
    assert resumed.fun == whole.fun
    assert torch.equal(tp.flatten_trainable(resumed.model), tp.flatten_trainable(whole.model))
    # the file records the whole state: a rerun past its end does nothing new
    again = tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=9,
                           checkpoint_path=path, checkpoint_every=2)
    assert torch.equal(tp.flatten_trainable(again.model), tp.flatten_trainable(whole.model))


def test_stopping_rule_and_non_finite_vector(monkeypatch):
    """The first iteration always runs (it == 0 or ‖g‖ > tol); a returned
    vector that is not finite reports the loss inf."""
    _, tm, _, tloss = _gpr()
    assert tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=50, tol=1e6).num_iters == 1
    monkeypatch.setattr(tfit, "lbfgs_step", lambda fn, vec, state: vec * float("nan"))
    res = tfit.fit_lbfgs(copy.deepcopy(tm), tloss, max_iters=3)
    assert res.fun == float("inf")


def test_fit_scipy_matches_jax():
    jm, tm, jloss, tloss = _gpr()
    jres = jfit.fit_scipy(jm, jloss, max_iters=200)
    res = tfit.fit_scipy(tm, tloss, max_iters=200)
    assert res.success and jres.success
    assert res.fun == pytest.approx(jres.fun, rel=LOSS_REL)
    # jit= is accepted and changes nothing
    again = tfit.fit_scipy(copy.deepcopy(_gpr()[1]), tloss, max_iters=200, jit=False)
    assert again.fun == res.fun
