"""The port's Adam loops against oak_tpu.optim.fit at float64, on a small SVGP
(D = 3, depth 2, N = 40, M = 8, sparsity prior) with the same perturbed
parameters in both packages: losses and trainable raws within 1e-8 of the
largest magnitude after 10 steps (torch.optim.Adam and optax compute the
same update with their floating-point operations in another order). Also the
train state: a resumed run equals the uninterrupted one exactly, and the file
has oak_tpu's layout. And the vector helpers of ``params``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.optim as jopt
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Gaussian
from oak_tpu_torch.optim import fit as tfit

REL = 1e-8
N, M, STEPS = 40, 8, 10

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _pair(tmp_path, seed=80):
    """(jax_model, torch_model, X, Y) with the JAX model's raws moved by
    seeded noise and q_mu drawn N(0, 1), bridged through an npz."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3))
    Y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=N))[:, None]
    kw = dict(num_dims=3, max_interaction_depth=2, use_sparsity_prior=True)
    jm = JSVGP.create(JOAKKernel.create(**kw, dtype=jnp.float64),
                      JGaussian.create(0.1, dtype=jnp.float64), X[:M], num_data=N,
                      dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**kw, **KW), Gaussian.create(0.1, **KW), X[:M], num_data=N)
    path = tmp_path / "pair.npz"
    jckpt.save_params(jm, path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key == "m.q_mu.raw":
            data[key] = rng.normal(size=data[key].shape)
        elif key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))
    return jm, tm, X, Y


def _vec(model):
    return tp.flatten_trainable(model).detach()


def _jvec(model):
    return np.asarray(jp.flatten_trainable(model)[0])


def _reference_losses(jm, loss_fn, steps, lr=1e-2):
    """optax Adam with fit_adam's masked update, step by step: the loss at
    each step's start point (oak_tpu's fit_adam keeps these inside its
    loop)."""
    vec, unflatten = jp.flatten_trainable(jm)
    opt = optax.adam(lr)

    @jax.jit
    def update(v, s):
        loss, g = jax.value_and_grad(lambda u: loss_fn(unflatten(u)))(v)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        up, s = opt.update(g, s)
        return optax.apply_updates(v, up), s, loss

    state, losses = opt.init(vec), []
    for _ in range(steps):
        vec, state, loss = update(vec, state)
        losses.append(float(loss))
    return np.array(losses), np.asarray(vec)


# --------------------------------------------------------------------------- #
def test_fit_adam_matches_jax(tmp_path):
    jm, tm, X, Y = _pair(tmp_path)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    res = tfit.fit_adam(tm, lambda m: m.training_loss(tX, tY), steps=STEPS)
    ref_losses, ref_last = _reference_losses(jm, lambda m: m.training_loss(jX, jY), STEPS)
    _close(res.losses, ref_losses)
    # the loss fell at every step, so oak_tpu's fit_adam returns the last
    # iterate, and the loss there
    assert np.all(np.diff(ref_losses) < 0)
    _close(_vec(res.model), ref_last)
    last = jax.jit(lambda v: jp.flatten_trainable(jm)[1](v).training_loss(jX, jY))(ref_last)
    assert res.fun == pytest.approx(float(last), rel=REL)
    assert res.model is tm and res.num_iters == STEPS and res.success


def test_fit_adam_batch_route_matches_jax(tmp_path):
    """Minibatches of 16 rows drawn per step from a seeded index stream;
    the last iterate and the last step's loss."""
    jm, tm, X, Y = _pair(tmp_path, seed=81)
    idx = np.random.default_rng(82).integers(0, N, size=(STEPS, 16))
    res = tfit.fit_adam(tm, lambda m, x, y: m.training_loss(x, y), steps=STEPS,
                        batch_fn=lambda i: (torch.as_tensor(X[idx[i]]),
                                            torch.as_tensor(Y[idx[i]])))
    jres = jopt.fit_adam(jm, lambda m, x, y: m.training_loss(x, y), steps=STEPS,
                         batch_fn=lambda i: (jnp.asarray(X[idx[i]]), jnp.asarray(Y[idx[i]])))
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    assert float(res.losses[-1]) == res.fun
    _close(_vec(res.model), _jvec(jres.model))


def test_fit_adam_masks_non_finite_gradients_like_jax(tmp_path):
    """sqrt(v - v0) of the likelihood variance v adds 0 to the loss and an
    infinite gradient entry at every step: the entry is set to 0, so v
    never moves and every loss stays finite, as in oak_tpu."""
    jm, tm, X, Y = _pair(tmp_path, seed=83)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    v0, jv0 = tm.likelihood.variance.value.detach(), jm.likelihood.variance.value
    res = tfit.fit_adam(tm, lambda m: m.training_loss(tX, tY)
                        + torch.sqrt(m.likelihood.variance.value - v0), steps=STEPS)
    jres = jopt.fit_adam(jm, lambda m: m.training_loss(jX, jY)
                         + jnp.sqrt(m.likelihood.variance.value - jv0), steps=STEPS)
    _, g = tfit.value_and_grad(tm, lambda m: torch.sqrt(m.likelihood.variance.value - v0),
                               _vec(tm))
    assert torch.isinf(g).any()
    assert torch.isfinite(res.losses).all()
    assert float(res.model.likelihood.variance.value.detach()) == float(v0)
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    _close(_vec(res.model), _jvec(jres.model))


def test_fit_adam_returns_best_finite_iterate_like_jax(tmp_path):
    """At lr 0.3 Adam moves q_mu[0, 0] by about 0.3 a step, and a term that
    is NaN once it is more than 0.35 from its start makes the later losses
    non-finite (its gradient stays finite): the best finite iterate is
    returned, not the last, as in oak_tpu."""
    jm, tm, X, Y = _pair(tmp_path, seed=84)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    q0 = float(tm.q_mu.value[0, 0].detach())

    def loss(m):
        return m.training_loss(tX, tY) + 0.0 * torch.log(0.35 ** 2 - (m.q_mu.value[0, 0] - q0) ** 2)

    def jloss(m):
        return m.training_loss(jX, jY) + 0.0 * jnp.log(0.35 ** 2 - (m.q_mu.value[0, 0] - q0) ** 2)

    res = tfit.fit_adam(tm, loss, steps=STEPS, lr=0.3)
    jres = jopt.fit_adam(jm, jloss, steps=STEPS, lr=0.3)
    losses = res.losses.numpy()
    assert not np.isfinite(losses[-1]) and np.isfinite(losses).any()
    assert res.fun == pytest.approx(np.nanmin(losses), rel=1e-12)
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    _close(_vec(res.model), _jvec(jres.model))


def test_fit_adam_scan_resume_equals_uninterrupted(tmp_path):
    """fit_adam_scan with a checkpoint every 3 steps, stopped after 6 and
    rerun to 10, ends where an uninterrupted 10-step run ends (exactly), and
    there where fit_adam and oak_tpu end; a rerun past the end runs
    nothing."""
    _, tm, X, Y = _pair(tmp_path, seed=85)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    start = _vec(tm).clone()

    def fresh():
        tp.assign_trainable(tm, start)
        return tm

    loss = lambda m: m.training_loss(tX, tY)  # noqa: E731
    whole = tfit.fit_adam_scan(fresh(), loss, steps=STEPS)
    whole_vec = _vec(whole.model).clone()
    ck = tmp_path / "train.npz"
    part = tfit.fit_adam_scan(fresh(), loss, steps=6, checkpoint_path=ck, checkpoint_every=3)
    assert part.num_iters == 6
    _, _, step = tfit.load_train_state(ck)
    assert step == 6
    resumed = tfit.fit_adam_scan(fresh(), loss, steps=STEPS, checkpoint_path=ck,
                                 checkpoint_every=3)
    assert resumed.num_iters == STEPS - 6 and resumed.success
    assert torch.equal(_vec(resumed.model), whole_vec)
    assert resumed.fun == whole.fun
    done = tfit.fit_adam_scan(fresh(), loss, steps=STEPS, checkpoint_path=ck)
    assert done.num_iters == 0 and done.success and "nothing to run" in done.message
    assert torch.equal(_vec(done.model), whole_vec)
    adam = tfit.fit_adam(fresh(), loss, steps=STEPS)
    _close(whole_vec, _vec(adam.model).numpy(), rel=1e-12)


def test_train_state_has_oak_tpu_layout(tmp_path):
    """The npz a torch run writes loads with oak_tpu's load_train_state into
    optax's Adam state, and back, unchanged."""
    _, tm, X, Y = _pair(tmp_path, seed=86)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    ck = tmp_path / "state.npz"
    tfit.fit_adam_scan(tm, lambda m: m.training_loss(tX, tY), steps=3,
                       checkpoint_path=ck, checkpoint_every=3)
    vec, leaves, step = tfit.load_train_state(ck, dtype=torch.float64)
    template = optax.adam(1e-2).init(jnp.zeros(vec.shape[0]))
    jvec, jstate, jstep = jopt.load_train_state(ck, template, dtype=jnp.float64)
    assert step == jstep == 3 and int(jstate[0].count) == int(leaves[0]) == 3
    _close(vec, np.asarray(jvec), rel=0)
    _close(leaves[1], np.asarray(jstate[0].mu), rel=0)
    _close(leaves[2], np.asarray(jstate[0].nu), rel=0)
    assert not (tmp_path / "state.npz.tmp").exists()


def test_trainable_vector_helpers():
    """unflatten_trainable / call_with / assign_trainable round-trip
    flatten_trainable, and call_with leaves the module as it was."""
    tm = SVGP.create(OAKKernel.create(num_dims=2, max_interaction_depth=2, **KW),
                     Gaussian.create(0.1, **KW), np.zeros((3, 2)))
    vec = _vec(tm)
    names = tp.trainable_names(tm)
    assert names[0] == "kernel.kernels.0.lengthscale.raw" and names[-1] == "q_sqrt.raw"
    new = vec + 1.0
    raws = tp.unflatten_trainable(tm, new)
    assert list(raws) == names
    got = tp.call_with(tm, raws, lambda m: tp.flatten_trainable(m))
    assert torch.equal(got, new) and torch.equal(_vec(tm), vec)
    tp.assign_trainable(tm, new)
    assert torch.equal(_vec(tm), new)
    with pytest.raises(ValueError, match="trainable values"):
        tp.assign_trainable(tm, new[:-1])
