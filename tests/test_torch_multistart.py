"""The port's multistarts (oak_tpu_torch.optim.multistart) against
oak_tpu.optim.multistart at float64: the jittered starts bitwise equal; the
best loss within 1e-8 relative and the same lane chosen (L-BFGS with the
Adam warm-up on a small GPR, Adam, natural gradients on a small SVGP); the
all-diverged case returns the caller's model untouched; accept_fn filters
the lanes; a checkpoint of all lanes resumes to the uninterrupted result."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.optim.multistart as jms
import oak_tpu.params as jp
from oak_tpu_torch import params as tp
from oak_tpu_torch.optim import multistart as tms
from tests.test_torch_lbfgs import _gpr
from tests.test_torch_natgrad import _pair as _svgp_pair

REL = 1e-8
MS = dict(n_starts=3, jitter=0.3, seed=0, include_init=True)


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _lanes(message):
    return [float(v) for v in message.split("losses: ")[1].rstrip(")").split(", ")]


@pytest.mark.parametrize("include_init", [True, False])
def test_make_starts_bitwise_equal(include_init):
    vec = np.random.default_rng(3).normal(size=17)
    ours = tms._make_starts(torch.as_tensor(vec), 4, 0.3, 7, include_init)
    theirs = jms._make_starts(jnp.asarray(vec), 4, 0.3, 7, include_init)
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.fixture(scope="module")
def gpr():
    return _gpr()


def _check_same_fit(res, jres, model):
    """The same best loss, the same lane chosen (oak_tpu's message prints
    the lanes' losses to 4 digits) and the same vector written into the
    model."""
    assert res.model is model
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    theirs = _lanes(jres.message)
    np.testing.assert_allclose(res.losses.numpy(), theirs, rtol=1e-3)
    assert len(set(theirs)) == len(theirs)
    assert int(torch.argmin(res.losses)) == int(np.argmin(theirs))
    _close(tp.flatten_trainable(model), jp.flatten_trainable(jres.model)[0], 1e-6)


def test_lbfgs_multistart_matches_jax(gpr):
    jm, tm, jloss, tloss = gpr
    # 8 iterations after the warm-up: the lanes are still apart (converged,
    # all three reach one basin here)
    kw = dict(MS, max_iters=8, warm_adam_steps=20)
    jres = jms.fit_lbfgs_multistart(jm, jloss, **kw)
    model = copy.deepcopy(tm)
    res = tms.fit_lbfgs_multistart(model, tloss, **kw)
    _check_same_fit(res, jres, model)
    assert res.success == jres.success and res.num_iters == int(jres.num_iters)
    # each lane's loss is that of its returned vector
    assert res.losses.shape == (3,) and float(res.losses.min()) == res.fun


def test_adam_multistart_matches_jax(gpr):
    jm, tm, jloss, tloss = gpr
    jres = jms.fit_adam_multistart(jm, jloss, steps=25, **MS)
    model = copy.deepcopy(tm)
    _check_same_fit(tms.fit_adam_multistart(model, tloss, steps=25, **MS), jres, model)


def test_natgrad_multistart_matches_jax(tmp_path):
    jm, tm, X, Y = _svgp_pair(tmp_path, q_diag=False)
    jX, jY, tX, tY = jnp.asarray(X), jnp.asarray(Y), torch.as_tensor(X), torch.as_tensor(Y)
    kw = dict(MS, steps=4, gamma=0.2)
    jres = jms.fit_natgrad_multistart(jm, lambda m: m.training_loss(jX, jY), **kw)
    res = tms.fit_natgrad_multistart(tm, lambda m: m.training_loss(tX, tY), **kw)
    _check_same_fit(res, jres, tm)


@pytest.mark.parametrize("kind", ["lbfgs", "adam", "natgrad"])
def test_all_lanes_diverged_returns_the_model_untouched(tmp_path, kind):
    if kind == "natgrad":
        _, model, X, Y = _svgp_pair(tmp_path, q_diag=False)
        X, Y = torch.as_tensor(X), torch.as_tensor(Y)

        def loss(m):
            return m.training_loss(X, Y) * float("nan")
    else:
        model = _gpr()[1]

        def loss(m):
            return m.training_loss() * float("nan")

    before = tp.flatten_trainable(model).detach().clone()
    fit = {"lbfgs": lambda: tms.fit_lbfgs_multistart(model, loss, max_iters=3,
                                                     warm_adam_steps=2, **MS),
           "adam": lambda: tms.fit_adam_multistart(model, loss, steps=3, **MS),
           "natgrad": lambda: tms.fit_natgrad_multistart(model, loss, steps=2, **MS)}[kind]
    res = fit()
    assert res.fun == float("inf") and not res.success and "diverged" in res.message
    assert res.model is model and torch.equal(tp.flatten_trainable(model), before)


def test_accept_fn_filters_the_lanes(gpr):
    _, tm, _, tloss = gpr
    kw = dict(MS, max_iters=40, warm_adam_steps=5)
    free = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, **kw)
    lanes = np.sort(free.losses.numpy())
    assert lanes[0] < lanes[1]  # distinct basins or at least distinct values

    def not_best(m):
        with torch.no_grad():
            return float(tloss(m)) > lanes[0] + 1e-9 * abs(lanes[0])

    seen = []
    filtered = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss,
                                        accept_fn=lambda m: seen.append(m) or not_best(m),
                                        **kw)
    assert filtered.fun == lanes[1]
    # each candidate is judged on its own copy, never on the caller's model
    assert all(m is not filtered.model for m in seen)
    # none accepted: the best overall
    none = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, accept_fn=lambda m: False, **kw)
    assert none.fun == lanes[0]


def test_checkpoint_resumes_every_lane(tmp_path, gpr):
    _, tm, _, tloss = gpr
    path = tmp_path / "ms.npz"
    kw = dict(MS, warm_adam_steps=5, chunk_iters=2)
    whole = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=8, **kw)
    tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=4, checkpoint_path=path, **kw)
    resumed = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=8,
                                       checkpoint_path=path, **kw)
    assert torch.equal(resumed.losses, whole.losses) and resumed.fun == whole.fun
    assert torch.equal(tp.flatten_trainable(resumed.model), tp.flatten_trainable(whole.model))
