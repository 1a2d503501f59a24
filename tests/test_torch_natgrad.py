"""Natural gradients against oak_tpu.optim.natgrad at float64, on a small SVGP
(D = 3, depth 2, N = 40, M = 8) with the same perturbed parameters: two
natgrad+Adam steps, fused and staggered, with a mean-field and a full q,
give the same losses and trainable raws within 1e-8 of the largest
magnitude (the Cholesky's reverse pass is torch's own here and Murray's
closed form there). One unit step with a Gaussian likelihood lands on
oak_tpu's collapsed SGPR bound. And the PSD helpers the step uses, among
them the failed Cholesky, which now gives NaN as in JAX instead of
raising."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.ops.psd as jpsd
import oak_tpu.optim.natgrad as jng
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import SGPR as JSGPR
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Gaussian
from oak_tpu_torch.ops import psd as tpsd
from oak_tpu_torch.optim import fit as tfit
from oak_tpu_torch.optim import natgrad as tng

REL = 1e-8
N, M = 40, 8

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _pair(tmp_path, q_diag, seed=95, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3))
    Y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=N))[:, None]
    kw = dict(num_dims=3, max_interaction_depth=2)
    jm = JSVGP.create(JOAKKernel.create(**kw, dtype=jnp.float64),
                      JGaussian.create(0.1, dtype=jnp.float64), X[:M], num_data=N,
                      q_diag=q_diag, dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**kw, **KW), Gaussian.create(0.1, **KW), X[:M],
                     num_data=N, q_diag=q_diag)
    path = tmp_path / "pair.npz"
    jckpt.save_params(jm, path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key == "m.q_mu.raw":
            data[key] = rng.normal(size=data[key].shape)
        elif key == "m.q_sqrt.raw" and not q_diag:
            data[key] = 0.5 * data[key] + np.tril(rng.normal(scale=0.05, size=data[key].shape))
        elif key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=noise, size=data[key].shape)
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))
    return jm, tm, X, Y


@pytest.mark.parametrize("staggered", [False, True], ids=["fused", "staggered"])
@pytest.mark.parametrize("q_diag", [True, False], ids=["diag_q", "full_q"])
def test_natgrad_adam_step_matches_jax(tmp_path, q_diag, staggered):
    jm, tm, X, Y = _pair(tmp_path, q_diag)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    vec = tfit._leaf(tm)
    opt = tfit.adam(vec)
    step = tng.natgrad_adam_step(opt, vec, tm, lambda m: m.training_loss(tX, tY), 0.5,
                                 staggered=staggered)
    jvec, unflatten = jp.flatten_trainable(jm)
    jopt = optax.adam(1e-2)
    jstep = jax.jit(jng.natgrad_adam_step(jopt, unflatten, lambda m: m.training_loss(jX, jY),
                                          0.5, staggered=staggered))
    jstate = jopt.init(jvec)
    for _ in range(2):
        loss = step()
        jvec, jstate, jloss = jstep(jvec, jstate)
        _close(loss, jloss)
        _close(vec, jvec)


def test_one_unit_step_lands_on_the_sgpr_bound(tmp_path):
    """Gaussian likelihood, full q: one natural step with γ = 1 puts q(u)
    at the optimum, where the SVGP bound equals oak_tpu's collapsed SGPR
    bound at the same kernel and noise; a second step does not move it."""
    jm, tm, X, Y = _pair(tmp_path, q_diag=False, seed=96)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)

    def loss(m):
        return -m.elbo(tX, tY)

    def natural_step():
        raws = tp.unflatten_trainable(tm, tp.flatten_trainable(tm).detach())
        _, (g1, g2), q = tng._eta_grads(tm, raws, loss, ())
        q_mu, q_sqrt = tng._apply_natural_step(*q, False, g1, g2, 1.0)
        tm.q_mu.assign(q_mu)
        tm.q_sqrt.assign(q_sqrt)
        return float(tm.elbo(tX, tY).detach())

    sgpr = JSGPR.create(X, Y, jm.kernel, X[:M],
                        noise_variance=float(jm.likelihood.variance.value))
    bound = float(sgpr.elbo())
    assert natural_step() == pytest.approx(bound, rel=REL)
    assert natural_step() == pytest.approx(bound, rel=REL)


def test_fit_natgrad_adam_matches_jax(tmp_path):
    """Three fused steps through the public loop; the q_diag warning."""
    jm, tm, X, Y = _pair(tmp_path, q_diag=False, seed=97)
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    res = tng.fit_natgrad_adam(tm, lambda m: m.training_loss(tX, tY), steps=3, gamma=0.2)
    jres = jng.fit_natgrad_adam(jm, lambda m: m.training_loss(jX, jY), steps=3, gamma=0.2)
    assert res.fun == pytest.approx(jres.fun, rel=REL) and res.success
    assert res.losses.shape == (3,) and float(res.losses[-1]) == res.fun
    _close(tp.flatten_trainable(res.model), jp.flatten_trainable(jres.model)[0])
    with pytest.warns(UserWarning, match="q_diag=True"):
        tng.warn_if_q_diag(SVGP.create(OAKKernel.create(num_dims=1, **KW),
                                       Gaussian.create(**KW), np.zeros((2, 1))))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tng.warn_if_q_diag(tm)


def test_fit_natgrad_scan_matches_jax_and_resumes(tmp_path):
    """fit_natgrad_scan on a minibatch index stream: oak_tpu's losses and
    raws after 4 steps; a run checkpointed at step 2 and resumed equals the
    uninterrupted one exactly."""
    jm, tm, X, Y = _pair(tmp_path, q_diag=False, seed=98)
    idx = np.random.default_rng(3).integers(0, N, size=(4, 16))
    tX, tY, jX, jY = torch.as_tensor(X), torch.as_tensor(Y), jnp.asarray(X), jnp.asarray(Y)
    kw = dict(steps=4, gamma=0.2)
    jres = jng.fit_natgrad_scan(jm, lambda m, i: m.training_loss(jX[i], jY[i]),
                                batch_args=(jnp.asarray(idx),), **kw)

    def loss(m, i):
        return m.training_loss(tX[i], tY[i])

    start = tp.flatten_trainable(tm).detach().clone()
    res = tng.fit_natgrad_scan(tm, loss, batch_args=(torch.as_tensor(idx),), **kw)
    assert res.model is tm and res.success and res.num_iters == 4
    assert res.fun == pytest.approx(jres.fun, rel=REL)
    _close(tp.flatten_trainable(tm), jp.flatten_trainable(jres.model)[0])

    path = tmp_path / "natgrad_state.npz"
    tp.assign_trainable(tm, start)
    tng.fit_natgrad_scan(tm, loss, batch_args=(torch.as_tensor(idx[:2]),), steps=2,
                         gamma=0.2, checkpoint_path=path, checkpoint_every=1)
    tp.assign_trainable(tm, start)
    resumed = tng.fit_natgrad_scan(tm, loss, batch_args=(torch.as_tensor(idx),),
                                   checkpoint_path=path, checkpoint_every=1, **kw)
    assert resumed.num_iters == 2 and resumed.fun == res.fun
    _close(tp.flatten_trainable(tm), jp.flatten_trainable(jres.model)[0])


def test_diag_step_rejects_overshoot_elementwise():
    """A step that would make θ2 non-negative keeps that entry's q."""
    q_mu = torch.tensor([[0.5], [1.0]], dtype=torch.float64)
    q_sqrt = torch.tensor([[1.0], [2.0]], dtype=torch.float64)
    g2 = torch.tensor([[-10.0], [0.0]], dtype=torch.float64)  # overshoots entry 0
    m, s = tng._apply_natural_step(q_mu, q_sqrt, True, torch.zeros_like(q_mu), g2, 1.0)
    assert float(m[0, 0]) == 0.5 and float(s[0, 0]) == 1.0
    _close(torch.cat([m[1], s[1]]), np.array([1.0, 2.0]), rel=1e-12)


# --------------------------------------------------------------------------- #
# PSD helpers
# --------------------------------------------------------------------------- #
def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T / n + np.eye(n)


def test_chol_of_inv_and_tri_inv_match_jax():
    rng = np.random.default_rng(98)
    P = np.stack([_spd(rng, 6), _spd(rng, 6)])
    T = tpsd.chol_of_inv(torch.as_tensor(P), 1e-10)
    for r in range(2):
        _close(T[r], jpsd.chol_of_inv(jnp.asarray(P[r]), 1e-10), 1e-10)
        _close(T[r] @ T[r].T, np.linalg.inv(P[r] + 1e-10 * np.eye(6)), 1e-10)
    L = np.linalg.cholesky(P[0])
    _close(tpsd.tri_inv_lower(torch.as_tensor(L)), jpsd.tri_inv_lower(jnp.asarray(L)), 1e-10)


def test_failed_cholesky_is_nan_like_jax():
    """A matrix that does not factorise gives the factor oak_tpu gives, NaN
    in the lower triangle, instead of raising (the fault ROADMAP §3
    records): batched, only the failed matrix is NaN."""
    bad = -np.eye(3)
    ref = np.asarray(jpsd.cholesky_lower(jnp.asarray(bad)))
    np.testing.assert_array_equal(tpsd.cholesky_lower(torch.as_tensor(bad)).numpy(), ref)
    np.testing.assert_array_equal(tpsd.cholesky(torch.as_tensor(bad), 1e-6).numpy(),
                                  np.asarray(jpsd.cholesky(jnp.asarray(bad), 1e-6)))
    assert np.isnan(ref[np.tril_indices(3)]).all()
    both = tpsd.cholesky_lower(torch.as_tensor(np.stack([np.eye(3), bad])))
    assert torch.equal(both[0], torch.eye(3, dtype=torch.float64))
    np.testing.assert_array_equal(both[1].numpy(), ref)
    # a loss through it is NaN, and Adam skips its gradient
    A = torch.tensor(bad, requires_grad=True)
    loss = tpsd.logdet_from_chol(tpsd.cholesky_lower(A))
    (g,) = torch.autograd.grad(loss, A)
    assert torch.isnan(loss) and torch.equal(tfit.finite_or_zero(g), torch.zeros_like(g))
