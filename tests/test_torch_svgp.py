"""The predict slice as a whole: an oak_tpu SVGP at float64 with perturbed
hyperparameters and nonzero q_mu is saved, loaded into the port, and both
packages must agree. Predictions within rel 1e-8 of the reference's largest
magnitude (oak_tpu applies an explicit inverse where the port solves);
everything else within 1e-10. Also the PSD helpers, the Gaussian
likelihood, and the port's import hygiene."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.measures as jmeas
import oak_tpu.ops.psd as jpsd
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Gaussian
from oak_tpu_torch.ops import psd as tpsd

PRED_REL = 1e-8
REL = 1e-10
N, M, DEPTH = 40, 12, 3

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _data(mixed, seed=51):
    rng = np.random.default_rng(seed)
    D = 5 if mixed else 4
    X = rng.normal(size=(N, D))
    if mixed:
        X[:, 0] = rng.integers(0, 2, N)
        X[:, 1] = rng.integers(0, 3, N)
    Y = np.tanh(X[:, -1]) + 0.3 * X[:, -2] * X[:, -1] + 0.1 * rng.normal(size=N)
    Z = X[rng.choice(N, M, replace=False)]
    return X, Y.reshape(-1, 1), Z


def _kernel_kwargs(mixed):
    kw = dict(max_interaction_depth=DEPTH, use_sparsity_prior=True,
              lengthscale_bounds=[1e-3, 1e3])
    if not mixed:
        return dict(num_dims=4, **kw), None
    loc = np.linspace(-2, 2, 9).reshape(-1, 1)
    kw.update(num_dims=5, p0=[0.4, None, None, None, None],
              p=[None, np.array([0.3, 0.3, 0.4]), None, None, None],
              empirical_locations=[None, None, None, loc, None])
    mog = (np.array([-0.5, 0.5]), np.array([0.7, 1.3]), np.array([0.4, 0.6]))
    return kw, mog


def _model_pair(tmp_path, q_diag=True, whiten=True, mixed=False):
    """(jax_model, torch_model, X, Y): the JAX model's trainable raws moved by
    seeded noise and q_mu drawn N(0, 1), then bridged through an npz."""
    X, Y, Z = _data(mixed)
    kw, mog = _kernel_kwargs(mixed)
    jkw, tkw = dict(kw), dict(kw)
    if mog is not None:
        jkw["gmm_measures"] = [None] * 4 + [jmeas.MOGMeasure.create(*mog)]
        tkw["gmm_measures"] = [None] * 4 + [tmeas.MOGMeasure.create(*mog, **KW)]
    jm = JSVGP.create(JOAKKernel.create(**jkw, dtype=jnp.float64),
                      JGaussian.create(0.05, dtype=jnp.float64), Z, num_data=N,
                      q_diag=q_diag, whiten=whiten, dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**tkw, **KW), Gaussian.create(0.05, **KW), Z,
                     num_data=N, q_diag=q_diag, whiten=whiten)
    path = tmp_path / "svgp.npz"
    jckpt.save_params(jm, path)
    rng = np.random.default_rng(52)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key == "m.q_mu.raw":
            data[key] = rng.normal(size=data[key].shape)
        elif key == "m.q_sqrt.raw" and not q_diag:
            data[key] = data[key] + np.tril(rng.normal(scale=0.1, size=data[key].shape))
        elif key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))
    return jm, tm, X, Y


CASES = [dict(q_diag=True), dict(q_diag=False), dict(q_diag=True, whiten=False),
         dict(q_diag=True, mixed=True)]
IDS = ["q_diag", "full_q", "unwhitened", "mixed_type"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_predict_matches_jax(tmp_path, case):
    jm, tm, X, Y = _model_pair(tmp_path, **case)
    tX, jX = torch.as_tensor(X), jnp.asarray(X)
    # one compiled JAX program per entry point (eager dispatch compiles
    # every primitive at every shape, which costs the suite seconds)
    jpredict = jax.jit(lambda m, x: (m.predict_f(x), m.predict_f(x[:5]),
                                     m.predict_f(x[:9], full_cov=True),
                                     m.predict_y(x)))
    j_lpd = jax.jit(lambda m, x, y: m.predict_log_density(x, y))
    jwide, jnarrow, jfull, jy = jpredict(jm, jX)
    # oak_tpu's wide (explicit inverse) and narrow (solve) branches
    for ours, ref in zip((tm.predict_f(tX), tm.predict_f(tX[:5]),
                          tm.predict_f(tX[:9], full_cov=True), tm.predict_y(tX)),
                         (jwide, jnarrow, jfull, jy)):
        _close(ours[0], ref[0], PRED_REL)
        _close(ours[1], ref[1], PRED_REL)
    _close(tm.predict_log_density(tX, torch.as_tensor(Y[:, 0])),
           j_lpd(jm, jX, jnp.asarray(Y[:, 0])), PRED_REL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_elbo_and_training_loss_match_jax(tmp_path, case):
    jm, tm, X, Y = _model_pair(tmp_path, **case)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    jkl, jelbo, jloss = jax.jit(lambda m, x, y: (m.prior_kl(), m.elbo(x, y),
                                                 m.training_loss(x, y)))(
        jm, jnp.asarray(X), jnp.asarray(Y))
    _close(tm.prior_kl(), jkl)
    _close(tm.elbo(tX, tY), jelbo)
    _close(tm.training_loss(tX, tY), jloss)


def test_training_loss_gradient_matches_jax(tmp_path):
    """Gradient w.r.t. every trainable raw, in flatten_trainable order (the
    CPU route differentiates the plain torch ops)."""
    jm, tm, X, Y = _model_pair(tmp_path)
    loss = tm.training_loss(torch.as_tensor(X), torch.as_tensor(Y))
    grads = torch.autograd.grad(loss, [p.raw for p in tp.trainable_params(tm)])
    jgrad = jax.jit(jax.grad(lambda m, x, y: m.training_loss(x, y)))(
        jm, jnp.asarray(X), jnp.asarray(Y))
    ref, _ = jp.flatten_trainable(jgrad)
    _close(torch.cat([g.reshape(-1) for g in grads]), ref, PRED_REL)


# --------------------------------------------------------------------------- #
# PSD helpers and the likelihood
# --------------------------------------------------------------------------- #
def _spd(rng, n, cond_scale=1.0):
    A = rng.normal(size=(n, n))
    return A @ A.T / n + cond_scale * np.eye(n)


def test_psd_helpers_match_jax():
    rng = np.random.default_rng(53)
    K = _spd(rng, 7)
    B = rng.normal(size=(7, 3))
    tK, tB, jK, jB = torch.as_tensor(K), torch.as_tensor(B), jnp.asarray(K), jnp.asarray(B)
    _close(tpsd.add_jitter(tK), jpsd.add_jitter(jK))
    _close(tpsd.add_jitter(tK, 1e-3), jpsd.add_jitter(jK, 1e-3))
    L, jL = tpsd.cholesky(tK), jpsd.cholesky(jK)
    _close(L, jL)
    _close(tpsd.solve_lower(L, tB), jpsd.solve_lower(jL, jB))
    _close(tpsd.solve_upper(L, tB), jpsd.solve_upper(jL, jB))
    _close(tpsd.cholesky_solve(L, tB), jpsd.cholesky_solve(jL, jB))
    _close(tpsd.logdet_from_chol(L), jpsd.logdet_from_chol(jL))


def test_safe_cholesky_escalates_like_jax():
    """A singular rank-1 all-ones matrix (the Kuu of a kernel whose
    lengthscales went to infinity) needs escalation; both packages pick the
    same jitter and the same factor."""
    K = np.ones((6, 6)) - 1e-5 * np.eye(6)  # indefinite until jitter > 1e-5
    L, j = tpsd.safe_cholesky(torch.as_tensor(K))
    jL, jj = jpsd.safe_cholesky(jnp.asarray(K))
    assert j == pytest.approx(float(jj)) and j > 1e-6
    _close(L, jL)
    # every try fails: L is all NaN, the JAX package's failure signal
    L_bad, _ = tpsd.safe_cholesky(torch.as_tensor(-np.eye(3)))
    assert torch.isnan(L_bad).all()


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(54)
    tl, jl = Gaussian.create(0.3, **KW), JGaussian.create(0.3)
    f, fvar, y = rng.normal(size=(8, 1)), rng.uniform(-0.01, 1.0, size=(8, 1)), rng.normal(size=(8, 1))
    tf, tfv, ty = (torch.as_tensor(a) for a in (f, fvar, y))
    jf, jfv, jy = (jnp.asarray(a) for a in (f, fvar, y))
    _close(tl.log_prob(tf, ty), jl.log_prob(jf, jy))
    _close(tl.variational_expectations(tf, tfv, ty), jl.variational_expectations(jf, jfv, jy))
    for a, b in zip(tl.predict_mean_and_var(tf, tfv), jl.predict_mean_and_var(jf, jfv)):
        _close(a, b)
    _close(tl.predict_log_density(tf, tfv, ty), jl.predict_log_density(jf, jfv, jy))
    # the clamp at 0: a negative fvar predicts the noise variance alone
    _, v = tl.predict_mean_and_var(tf, torch.full_like(tfv, -1.0))
    _close(v, np.full((8, 1), 0.3))


def test_port_imports_no_jax():
    code = ("import sys, oak_tpu_torch, oak_tpu_torch.checkpoint, oak_tpu_torch._build, "
            "oak_tpu_torch.ops.oak_gram, oak_tpu_torch.ops.psd, "
            "oak_tpu_torch.ops.newton_girard, oak_tpu_torch.models.svgp, "
            "oak_tpu_torch.utils.diagnostics, oak_tpu_torch.optim, "
            "oak_tpu_torch.optim.natgrad, oak_tpu_torch.ops.quadrature, "
            "oak_tpu_torch.models.likelihoods, oak_tpu_torch.testing, "
            "oak_tpu_torch.sobol, oak_tpu_torch.models.gpr, "
            "oak_tpu_torch.models.sgpr, oak_tpu_torch.models.sampling, "
            "oak_tpu_torch.model, oak_tpu_torch.flows, oak_tpu_torch.preprocessing, "
            "oak_tpu_torch.optim.multistart, oak_tpu_torch.utils.summary\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'oak_tpu')]\n"
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
