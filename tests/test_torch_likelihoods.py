"""The Bernoulli likelihood and Gauss–Hermite quadrature against
oak_tpu.models.likelihoods and oak_tpu.ops.quadrature at float64 (rel
1e-12: the same nodes and the same sums), the two f32 gradient guards
(PARITY_NOTES 6b and 6c), and a Bernoulli SVGP's training loss and its
gradient against oak_tpu's (rel 1e-8, as tests/test_torch_svgp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.checkpoint as jckpt
import oak_tpu.ops.quadrature as jq
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Bernoulli as JBernoulli
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Bernoulli
from oak_tpu_torch.ops import quadrature as tq

REL = 1e-12

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _inputs(seed=90, n=12):
    rng = np.random.default_rng(seed)
    fmu = rng.normal(scale=2.0, size=(n, 1))
    fvar = rng.uniform(0.01, 3.0, size=(n, 1))
    fvar[:2, 0] = (0.0, -1e-3)  # the floor of _safe_scale
    y = rng.integers(0, 2, size=(n, 1)).astype(float)
    return fmu, fvar, y


@pytest.mark.parametrize("num_points", [7, 20])
def test_quadrature_matches_jax(num_points):
    fmu, fvar, _ = _inputs()
    x, w = tq._gh_points(num_points)
    jx, jw = jq._gh_points(num_points)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)
    t = (torch.as_tensor(fmu), torch.as_tensor(fvar))
    j = (jnp.asarray(fmu), jnp.asarray(fvar))
    _close(tq.gauss_hermite(torch.sin, *t, num_points), jq.gauss_hermite(jnp.sin, *j, num_points))
    _close(tq.log_gauss_hermite(lambda f: -f * f, *t, num_points),
           jq.log_gauss_hermite(lambda f: -f * f, *j, num_points))


def test_safe_scale_floors():
    for dtype, floor in ((torch.float32, 1e-10), (torch.float64, 1e-30)):
        s = tq._safe_scale(torch.tensor([-1.0, 0.0, 4.0], dtype=dtype))
        assert s.dtype == dtype
        np.testing.assert_allclose(s.numpy(), [np.sqrt(floor), np.sqrt(floor), 2.0], rtol=1e-6)


@pytest.mark.parametrize("link", ["logit", "probit"])
def test_bernoulli_matches_jax(link):
    fmu, fvar, y = _inputs(seed=91)
    tl, jl = Bernoulli.create(link), JBernoulli.create(link)
    t = [torch.as_tensor(a) for a in (fmu, fvar, y)]
    j = [jnp.asarray(a) for a in (fmu, fvar, y)]
    _close(tl.log_prob(t[0], t[2]), jl.log_prob(j[0], j[2]))
    _close(tl.variational_expectations(*t), jl.variational_expectations(*j))
    for a, b in zip(tl.predict_mean_and_var(t[0], t[1]), jl.predict_mean_and_var(j[0], j[1])):
        _close(a, b)
    _close(tl.predict_log_density(*t), jl.predict_log_density(*j))
    assert tp.keypath_nodes(tl) == []
    with pytest.raises(ValueError, match="invlink"):
        Bernoulli.create("tanh")


@pytest.mark.parametrize("link", ["logit", "probit"])
def test_bernoulli_gradient_finite_at_extreme_f(link):
    """A cold deep prior's quadrature grid reaches f ≈ -100 in f32, where a
    naive logistic link overflows with a NaN backward (PARITY_NOTES 6b)."""
    lik = Bernoulli.create(link)
    fmu = torch.tensor([[0.0], [30.0], [-30.0]], requires_grad=True)
    fvar = torch.tensor([[188.0], [200.0], [150.0]], requires_grad=True)
    y = torch.tensor([[1.0], [0.0], [1.0]])
    ve = lik.variational_expectations(fmu, fvar, y).sum()
    gmu, gv = torch.autograd.grad(ve, (fmu, fvar))
    assert torch.isfinite(ve) and torch.isfinite(gmu).all() and torch.isfinite(gv).all()
    grid, _ = tq._grid(fmu.detach(), fvar.detach(), 20)
    assert float(grid.min()) < -100.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quadrature_gradient_is_zero_where_variance_is_not_positive(dtype):
    """The floor of the quadrature's scale sends the cotangent of a variance
    at or below 0 to the clamped branch: exactly 0, never inf
    (PARITY_NOTES 6c); finite and nonzero elsewhere."""
    lik = Bernoulli.create("logit")
    y = torch.tensor([[1.0], [0.0], [1.0]], dtype=dtype)
    fmu = torch.tensor([[0.3], [-0.2], [1.0]], dtype=dtype)
    for bad in (0.0, -1e-6, -3e-8):
        fvar = torch.tensor([[bad], [0.7], [bad]], dtype=dtype, requires_grad=True)
        for out in (lik.variational_expectations(fmu, fvar, y),
                    tq.gauss_hermite(lik.invlink, fmu, fvar),
                    lik.predict_log_density(fmu, fvar, y)):
            (g,) = torch.autograd.grad(out.sum(), fvar)
            assert g[0, 0] == 0.0 and g[2, 0] == 0.0, bad
            assert torch.isfinite(g[1, 0]) and g[1, 0] != 0.0, bad


def test_bernoulli_svgp_loss_and_gradient_match_jax(tmp_path):
    """A Bernoulli SVGP (D = 3, depth 2, N = 40, M = 8) with perturbed
    raws and nonzero q_mu: training loss and its gradient w.r.t. every
    trainable raw, in flatten_trainable order, within 1e-8 of oak_tpu."""
    rng = np.random.default_rng(92)
    X = rng.normal(size=(40, 3))
    Y = (np.sin(X[:, 0]) + X[:, 1] * X[:, 2] > 0).astype(float)[:, None]
    kw = dict(num_dims=3, max_interaction_depth=2, use_sparsity_prior=True)
    jm = JSVGP.create(JOAKKernel.create(**kw, dtype=jnp.float64), JBernoulli.create(),
                      X[:8], num_data=40, dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**kw, **KW), Bernoulli.create(), X[:8], num_data=40)
    path = tmp_path / "bernoulli.npz"
    jckpt.save_params(jm, path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))

    loss = tm.training_loss(torch.as_tensor(X), torch.as_tensor(Y))
    grads = torch.autograd.grad(loss, [p.raw for p in tp.trainable_params(tm)])
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda m, x, y: m.training_loss(x, y)))(
        jm, jnp.asarray(X), jnp.asarray(Y))
    _close(loss, jloss, 1e-8)
    _close(torch.cat([g.reshape(-1) for g in grads]), jp.flatten_trainable(jgrad)[0], 1e-8)
