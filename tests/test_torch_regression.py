"""GPR, SGPR, the posterior statistics of every model, the checkpoint bridge
for the regression models and posterior sampling, against oak_tpu at
float64. The JAX model's trainable raws are moved by seeded noise and bridged
into the port through the keypath npz; objectives, gradients (w.r.t. every
trainable raw, in flatten_trainable order), predictions and posterior
statistics must agree within rel 1e-8 of the reference's largest magnitude
(oak_tpu refines its factors and solves for the TPU's bf16; the port solves
directly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.measures as jmeas
import oak_tpu.models.sgpr as jsgpr
import oak_tpu.ops.psd as jpsd
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import GPR as JGPR
from oak_tpu.models import SGPR as JSGPR
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import GPR, SGPR, SVGP, Gaussian
from oak_tpu_torch.models import sgpr as tsgpr
from oak_tpu_torch.models.sampling import sample_mvn_columns
from tests.test_torch_svgp import CASES as SVGP_CASES
from tests.test_torch_svgp import IDS as SVGP_IDS
from tests.test_torch_svgp import _close, _data, _kernel_kwargs, _model_pair

REL = 1e-8

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def regression_pair(tmp_path, kind, mixed=False, trainable_Z=False, outputs=1,
                    seed=71):
    """(jax_model, torch_model, X, Y) for kind "gpr" or "sgpr" at float64,
    the trainable raws moved by seeded noise and bridged through an npz."""
    X, Y, Z = _data(mixed)
    if outputs == 2:
        Y = np.concatenate([Y, np.sin(2.0 * X[:, -1:])], axis=1)
    kw, mog = _kernel_kwargs(mixed)
    jkw, tkw = dict(kw), dict(kw)
    if mog is not None:
        jkw["gmm_measures"] = [None] * 4 + [jmeas.MOGMeasure.create(*mog)]
        tkw["gmm_measures"] = [None] * 4 + [tmeas.MOGMeasure.create(*mog, **KW)]
    jk, tk = JOAKKernel.create(**jkw, dtype=jnp.float64), OAKKernel.create(**tkw, **KW)
    if kind == "gpr":
        jm = JGPR.create(X, Y, jk, noise_variance=0.05)
        tm = GPR.create(X, Y, tk, noise_variance=0.05)
    else:
        jm = JSGPR.create(X, Y, jk, Z, noise_variance=0.05, trainable_Z=trainable_Z)
        tm = SGPR.create(X, Y, tk, Z, noise_variance=0.05, trainable_Z=trainable_Z)
    path = tmp_path / f"{kind}.npz"
    jckpt.save_params(jm, path)
    rng = np.random.default_rng(seed)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))
    return jm, tm, X, Y


PAIRS = [dict(kind="gpr"), dict(kind="gpr", mixed=True), dict(kind="sgpr"),
         dict(kind="sgpr", mixed=True), dict(kind="sgpr", trainable_Z=True)]
PAIR_IDS = ["gpr", "gpr_mixed", "sgpr", "sgpr_mixed", "sgpr_trainable_Z"]


@pytest.fixture(scope="module", params=PAIRS, ids=PAIR_IDS)
def pair(request, tmp_path_factory):
    return regression_pair(tmp_path_factory.mktemp("pair"), **request.param)


def _objective(m):
    return m.log_marginal_likelihood() if hasattr(m, "log_marginal_likelihood") \
        else m.elbo()


def _grad(tm):
    loss = tm.training_loss()
    grads = torch.autograd.grad(loss, [p.raw for p in tp.trainable_params(tm)])
    return loss, torch.cat([g.reshape(-1) for g in grads])


def _jax_grad(jm):
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda m: m.training_loss()))(jm)
    return jloss, jp.flatten_trainable(jgrad)[0]


def test_regression_objective_and_gradient_match_jax(pair):
    jm, tm, _, _ = pair
    _close(_objective(tm), jax.jit(_objective)(jm), REL)
    loss, g = _grad(tm)
    jloss, jg = _jax_grad(jm)
    _close(loss, jloss, REL)
    _close(g, jg, REL)


def test_regression_predictions_match_jax(pair):
    jm, tm, X, Y = pair
    rng = np.random.default_rng(72)
    Xs = rng.normal(size=(9, X.shape[1]))
    discrete = 2 if X.shape[1] == 5 else 0  # the mixed model's binary, categorical dims
    Xs[:, :discrete] = X[:9, :discrete]
    tXs, jXs = torch.as_tensor(Xs), jnp.asarray(Xs)
    jout = jax.jit(lambda m, x, y: (m.predict_f(x), m.predict_f(x, full_cov=True),
                                    m.predict_y(x), m.predict_log_density(x, y)))(
        jm, jXs, jnp.asarray(Y[:9]))
    tout = (tm.predict_f(tXs), tm.predict_f(tXs, full_cov=True), tm.predict_y(tXs),
            tm.predict_log_density(tXs, torch.as_tensor(Y[:9])))
    for ours, ref in zip(tout[:3], jout[:3]):
        _close(ours[0], ref[0], REL)
        _close(ours[1], ref[1], REL)
    _close(tout[3], jout[3], REL)


def test_regression_posterior_stats_match_jax(pair):
    jm, tm, _, _ = pair
    jalpha, (ja, jQ) = jax.jit(lambda m: (m.posterior_alpha(), m.posterior_stats()))(jm)
    _close(tm.posterior_alpha(), jalpha, REL)
    alpha, Qinv = tm.posterior_stats()
    _close(alpha, ja, REL)
    _close(Qinv, jQ, REL)
    Zj = jm.inducing_points
    assert (tm.inducing_points is None) == (Zj is None)
    if Zj is not None:
        _close(tm.inducing_points, Zj, 1e-15)
    for ours, ref in zip(tm.data, jm.data):
        _close(ours, ref, 1e-15)


@pytest.mark.parametrize("case", SVGP_CASES, ids=SVGP_IDS)
def test_svgp_posterior_stats_match_jax(tmp_path, case):
    jm, tm, _, _ = _model_pair(tmp_path, **case)
    jalpha, (ja, jQ) = jax.jit(lambda m: (m.posterior_alpha(), m.posterior_stats()))(jm)
    _close(tm.posterior_alpha(), jalpha, REL)
    alpha, Qinv = tm.posterior_stats()
    _close(alpha, ja, REL)
    _close(Qinv, jQ, REL)
    _close(tm.inducing_points, jm.inducing_points, 1e-15)


def test_sgpr_bound_with_every_clamp_active_matches_jax(tmp_path, monkeypatch):
    """Both packages' Cholesky factors inside SGPR scaled, Kuu's (default
    jitter) by 0.3 and B's (jitter 0) by 0.02: diag(LB) drops below 1,
    ||c||² rises above yᵀy/σ² and tr(AAᵀ) above Σ K_diag/σ², breaking the
    three inequalities the bound enforces. The clamped bound, loss and
    gradient still agree with oak_tpu's."""
    jm, tm, _, _ = regression_pair(tmp_path, "sgpr")
    j_chol, t_chol = jsgpr.cholesky, tsgpr.cholesky

    def scale(jitter):
        return 0.02 if jitter == 0.0 else 0.3

    monkeypatch.setattr(jsgpr, "cholesky", lambda K, jitter=None: scale(jitter) * j_chol(K, jitter))
    monkeypatch.setattr(tsgpr, "cholesky", lambda K, jitter=None: scale(jitter) * t_chol(K, jitter))
    with torch.no_grad():
        _, A, LB, c, sigma2 = tm._common()
        ydata = 0.5 * torch.sum(tm.Y * tm.Y) / sigma2
        kdiag = torch.sum(tm.kernel.K_diag(tm.X)) / sigma2
    assert torch.diagonal(LB).min() < 1.0
    assert 0.5 * torch.sum(c * c) > ydata
    assert kdiag - torch.sum(A * A) < 0.0
    _close(tm.elbo(), jax.jit(lambda m: m.elbo())(jm), REL)
    loss, g = _grad(tm)
    jloss, jg = _jax_grad(jm)
    _close(loss, jloss, REL)
    _close(g, jg, REL)


def test_port_sgpr_bound_capped_under_perturbation():
    """float32, raws moved far from a healthy start (the regime where the
    unclamped bound fabricated -5e8 nats of reward): every finite bound is
    at most the σ-only terms, -N·R/2·(log 2π + log σ²)."""
    rng = np.random.default_rng(73)
    X = rng.normal(size=(40, 3))
    Y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=40))[:, None]
    kern = OAKKernel.create(num_dims=3, max_interaction_depth=2, dtype=torch.float32,
                            device="cpu")
    m = SGPR.create(X, Y, kern, X[:12], noise_variance=0.01)
    vec0 = tp.flatten_trainable(m).detach().clone()
    finite = 0
    for scale, seed in ((0.3, 0), (3.0, 1), (10.0, 2), (30.0, 3)):
        noise = np.random.default_rng(seed).standard_normal(vec0.shape)
        tp.assign_trainable(m, vec0 + scale * torch.as_tensor(noise, dtype=vec0.dtype))
        with torch.no_grad():
            elbo = float(m.elbo())
            sigma2 = float(m.likelihood.variance.value)
        if not np.isfinite(elbo):
            continue  # a NaN is an honest failure; fabricated reward is not
        finite += 1
        cap = -0.5 * Y.size * (np.log(2 * np.pi) + np.log(sigma2))
        assert elbo <= cap + 1e-3 * abs(cap) + 1.0, (scale, elbo, cap)
    assert finite > 0


@pytest.mark.parametrize("kind", ["gpr", "sgpr"])
def test_checkpoint_round_trip_both_directions(tmp_path, kind):
    """oak_tpu's npz loads into the port (in ``regression_pair``); the
    port's save_params loads into oak_tpu's template, leaf for leaf, and the
    reloaded JAX model gives the port's loss."""
    jm, tm, _, _ = regression_pair(tmp_path, kind)
    with torch.no_grad():
        for p in tp.trainable_params(tm):
            p.raw.add_(0.05)
    path = tmp_path / "port.npz"
    tckpt.save_params(tm, path)
    jm2 = jckpt.load_params(jm, path)
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files}
    assert {"m.X", "m.Y"} <= set(saved) and (("m.Z.raw" in saved) == (kind == "sgpr"))
    loaded = jckpt._flat_with_keys(jm2, "m")
    assert set(loaded) == set(saved)
    for key, arr in saved.items():
        np.testing.assert_array_equal(loaded[key], arr, err_msg=key)
    _close(tm.training_loss(), jax.jit(lambda m: m.training_loss())(jm2), REL)


# --------------------------------------------------------------------------- #
# Posterior sampling
# --------------------------------------------------------------------------- #
def test_sampling_factor_is_jax_safe_cholesky(tmp_path):
    """The draws are mean + L eps with L JAX's safe_cholesky of the same
    predictive covariance, for one shared covariance (GPR) and per-latent
    ones (SVGP, full q)."""
    _, gpr, X, _ = regression_pair(tmp_path, "gpr")
    _, svgp, _, _ = _model_pair(tmp_path, q_diag=False)
    Xs = torch.as_tensor(X[:7])
    for model in (gpr, svgp):
        with torch.no_grad():
            mean, cov = model.predict_f(Xs, full_cov=True)
            draws = model.predict_f_samples(Xs, num_samples=5, generator_or_seed=11)
        eps = torch.randn((5,) + tuple(mean.shape), dtype=mean.dtype,
                          generator=torch.Generator().manual_seed(11))
        covs = cov.numpy() if cov.dim() == 3 else cov.numpy()[None]
        Ls = np.stack([np.asarray(jpsd.safe_cholesky(jnp.asarray(c))[0]) for c in covs])
        expect = mean.numpy()[None] + np.einsum(
            "rst,ntr->nsr", np.broadcast_to(Ls, (mean.shape[1],) + Ls.shape[1:]),
            eps.numpy())
        _close(draws, expect, 1e-12)


def _check_moments(model, Xs, n_samples=4000):
    with torch.no_grad():
        mu, var = (t.numpy() for t in model.predict_f(Xs))
        _, cov = model.predict_f(Xs, full_cov=True)
        draws = model.predict_f_samples(Xs, num_samples=n_samples,
                                        generator_or_seed=3).numpy()
    cov = cov.numpy() if cov.dim() == 2 else cov.numpy()[0]
    assert draws.shape == (n_samples, Xs.shape[0], mu.shape[1])
    se = np.sqrt(var / n_samples)
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=5 * se.max() + 1e-6)
    np.testing.assert_allclose(draws.var(axis=0), var, rtol=0.15, atol=1e-6)
    emp_c01 = np.cov(draws[:, 0, 0], draws[:, 1, 0])[0, 1]
    tol = 5 * np.sqrt(cov[0, 0] * cov[1, 1] / n_samples) + 0.1 * abs(cov[0, 1]) + 1e-6
    assert abs(emp_c01 - cov[0, 1]) < tol


@pytest.mark.parametrize("kind", ["gpr", "sgpr", "svgp_q_diag", "svgp_full_q"])
def test_sample_moments_match_predictive(tmp_path, kind):
    if kind.startswith("svgp"):
        _, model, X, _ = _model_pair(tmp_path, q_diag=kind == "svgp_q_diag")
    else:
        _, model, X, _ = regression_pair(tmp_path, kind)
    _check_moments(model, torch.as_tensor(X[:6]))


def test_samples_reproducible_by_seed_and_generator(tmp_path):
    _, m, X, _ = regression_pair(tmp_path, "sgpr", outputs=2)
    Xs = torch.as_tensor(X[:4])
    with torch.no_grad():
        a = m.predict_f_samples(Xs, num_samples=2, generator_or_seed=7)
        b = m.predict_f_samples(Xs, num_samples=2, generator_or_seed=7)
        c = m.predict_f_samples(Xs, num_samples=2, generator_or_seed=8)
        d = m.predict_f_samples(Xs, 2, torch.Generator().manual_seed(7))
    assert a.shape == (2, 4, 2)
    assert torch.equal(a, b) and torch.equal(a, d)
    assert not torch.allclose(a, c)
    mean, cov = m.predict_f(Xs, full_cov=True)
    e = sample_mvn_columns(torch.Generator().manual_seed(7), mean.detach(),
                           cov.detach(), 2)
    assert torch.equal(a, e)
