"""The port's 1-D kernels, OAKKernel and Newton–Girard against oak_tpu at
float64, relative tolerance 1e-10 of the reference's largest magnitude.
Parameters cross from the JAX objects to the port through the keypath
bridge; inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.kernels.ortho_binary as jbin
import oak_tpu.kernels.ortho_categorical as jcat
import oak_tpu.kernels.ortho_rbf as jrbf
import oak_tpu.measures as jmeas
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.kernels import UnconstrainedRBF as JUnconstrainedRBF
from oak_tpu.kernels import component_index_tuples as j_component_index_tuples
from oak_tpu.kernels import kernel_K as j_kernel_K
from oak_tpu.kernels import kernel_K_diag as j_kernel_K_diag
from oak_tpu.ops.newton_girard import newton_girard as j_newton_girard
from oak_tpu.ops.newton_girard import power_sums as j_power_sums
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch import params as tp
from oak_tpu_torch.checkpoint import load_params
from oak_tpu_torch.kernels import (OAKKernel, OrthogonalBinary,
                                   OrthogonalCategorical, OrthogonalRBF,
                                   UnconstrainedRBF, component_index_tuples,
                                   kernel_K, kernel_K_diag)
from oak_tpu_torch.kernels import ortho_binary as tbin
from oak_tpu_torch.kernels import ortho_categorical as tcat
from oak_tpu_torch.kernels import ortho_rbf as trbf
from oak_tpu_torch.ops import newton_girard as tng

REL = 1e-10

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _bridge(jobj, tobj, noise_seed=None):
    """Copy jobj's leaves into tobj (keys 'm' + JAX keystr); with a seed,
    first move every Param raw except inducing inputs by N(0, 0.3) noise,
    and return the JAX object rebuilt from the same values."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(jobj)
    data = {"m" + jax.tree_util.keystr(kp): np.asarray(leaf) for kp, leaf in flat}
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
        for key in data:
            if key.endswith(".raw") and key != "m.Z.raw":
                data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
        jobj = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(data["m" + jax.tree_util.keystr(kp)]) for kp, _ in flat])
    load_params(tobj, data)
    return jobj


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _measure_pair(name):
    if name == "gaussian":
        return jmeas.GaussianMeasure.create(0.3, 1.7), tmeas.GaussianMeasure.create(0.3, 1.7, **KW)
    if name == "uniform":
        return jmeas.UniformMeasure.create(-1.0, 2.0), tmeas.UniformMeasure.create(-1.0, 2.0, **KW)
    if name == "empirical":
        rng = np.random.default_rng(21)
        loc = rng.normal(size=(9, 1))
        w = rng.uniform(0.5, 1.5, size=(9, 1))
        w = w / w.sum()
        return jmeas.EmpiricalMeasure.create(loc, w), tmeas.EmpiricalMeasure.create(loc, w, **KW)
    means, variances, weights = [-0.5, 0.5], [0.7, 1.3], [0.4, 0.6]
    return (jmeas.MOGMeasure.create(np.array(means), np.array(variances), np.array(weights)),
            tmeas.MOGMeasure.create(means, variances, weights, **KW))


@pytest.mark.parametrize("measure", ["gaussian", "uniform", "empirical", "mog"])
def test_ortho_rbf_matches_jax(measure):
    jm, tm = _measure_pair(measure)
    jk = jrbf.OrthogonalRBF.create(jm, lengthscale=0.8, variance=1.3)
    tk = OrthogonalRBF.create(tm, lengthscale=0.8, variance=1.3)
    jk = _bridge(jk, tk, noise_seed=22)
    rng = np.random.default_rng(23)
    x, x2 = rng.normal(size=17), rng.normal(size=11)
    jx, jx2 = jnp.asarray(x), jnp.asarray(x2)
    _close(trbf.cov_x_s(tk, _t(x)), jrbf.cov_x_s(jk, jx))
    _close(trbf.var_s(tk), jrbf.var_s(jk))
    _close(trbf.K(tk, _t(x), _t(x2)), jrbf.K(jk, jx, jx2))
    _close(trbf.K(tk, _t(x)), jrbf.K(jk, jx))
    _close(trbf.K_diag(tk, _t(x)), jrbf.K_diag(jk, jx))


def test_var_s_floor_keeps_pruned_dim_finite():
    tk = OrthogonalRBF.create(tmeas.GaussianMeasure.create(0.0, 1.0, **KW), variance=1.0)
    tk.variance.assign(0.0)
    x = _t(np.linspace(-1, 1, 5))
    K = trbf.K(tk, x)
    assert torch.isfinite(K).all() and float(K.detach().abs().max()) == 0.0


def test_binary_matches_jax():
    jk = jbin.OrthogonalBinary.create(p0=0.3, variance=1.7)
    tk = OrthogonalBinary.create(p0=0.3, variance=1.7, **KW)
    jk = _bridge(jk, tk, noise_seed=24)
    rng = np.random.default_rng(25)
    x = rng.integers(0, 2, 13).astype(np.float64)
    x2 = rng.integers(0, 2, 7).astype(np.float64)
    _close(tbin.K(tk, _t(x), _t(x2)), jbin.K(jk, jnp.asarray(x), jnp.asarray(x2)))
    _close(tbin.K_diag(tk, _t(x)), jbin.K_diag(jk, jnp.asarray(x)))


def test_categorical_matches_jax():
    p = [0.2, 0.5, 0.3]
    jk = jcat.OrthogonalCategorical.create(p, rank=2, variance=1.4,
                                           key=jax.random.PRNGKey(3))
    tk = OrthogonalCategorical.create(p, rank=2, variance=1.4,
                                      generator=torch.Generator().manual_seed(3), **KW)
    jk = _bridge(jk, tk, noise_seed=26)
    rng = np.random.default_rng(27)
    x = rng.integers(0, 3, 13).astype(np.float64)
    x2 = rng.integers(0, 3, 7).astype(np.float64)
    _close(tcat.K(tk, _t(x), _t(x2)), jcat.K(jk, jnp.asarray(x), jnp.asarray(x2)))
    _close(tcat.K_diag(tk, _t(x)), jcat.K_diag(jk, jnp.asarray(x)))
    _close(tcat.output_covariance(tk), jcat.output_covariance(jk))


def test_unconstrained_rbf_matches_jax():
    jk = JUnconstrainedRBF.create(lengthscale=0.6, variance=2.0)
    tk = UnconstrainedRBF.create(lengthscale=0.6, variance=2.0, **KW)
    jk = _bridge(jk, tk, noise_seed=28)
    rng = np.random.default_rng(29)
    x, x2 = rng.normal(size=9), rng.normal(size=5)
    _close(kernel_K(tk, _t(x), _t(x2)), j_kernel_K(jk, jnp.asarray(x), jnp.asarray(x2)))
    _close(kernel_K_diag(tk, _t(x)), j_kernel_K_diag(jk, jnp.asarray(x)))


# --------------------------------------------------------------------------- #
# OAKKernel
# --------------------------------------------------------------------------- #
def _mixed_kwargs():
    """binary dim 0, categorical dim 1 (3 cats), Gaussian RBF dim 2,
    empirical-measure RBF dim 3, MOG RBF dim 4."""
    loc = np.linspace(-2, 2, 9).reshape(-1, 1)
    w = np.full((9, 1), 1 / 9.0)
    return dict(p0=[0.4, None, None, None, None],
                p=[None, np.array([0.3, 0.3, 0.4]), None, None, None],
                empirical_locations=[None, None, None, loc, None],
                empirical_weights=[None, None, None, w, None])


def _mog_pair():
    args = (np.array([-0.5, 0.5]), np.array([0.7, 1.3]), np.array([0.4, 0.6]))
    return jmeas.MOGMeasure.create(*args), tmeas.MOGMeasure.create(*args, **KW)


def _mixed_inputs(rng, N, M):
    X = rng.normal(size=(N, 5))
    X2 = rng.normal(size=(M, 5))
    X[:, 0], X2[:, 0] = rng.integers(0, 2, N), rng.integers(0, 2, M)
    X[:, 1], X2[:, 1] = rng.integers(0, 3, N), rng.integers(0, 3, M)
    return X, X2


def _oak_pair(kind, depth=3, **extra):
    if kind == "rbf":
        kw = dict(num_dims=4, max_interaction_depth=depth, **extra)
        return JOAKKernel.create(**kw), OAKKernel.create(**kw, **KW)
    jmog, tmog = _mog_pair()
    kw = dict(num_dims=5, max_interaction_depth=depth, **_mixed_kwargs(), **extra)
    return (JOAKKernel.create(gmm_measures=[None] * 4 + [jmog], **kw),
            OAKKernel.create(gmm_measures=[None] * 4 + [tmog], **kw, **KW))


@pytest.mark.parametrize("kind", ["rbf", "mixed"])
def test_oak_kernel_matches_jax(kind):
    jk, tk = _oak_pair(kind, use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3])
    jk = _bridge(jk, tk, noise_seed=31)
    rng = np.random.default_rng(32)
    if kind == "rbf":
        X, X2 = rng.normal(size=(23, 4)), rng.normal(size=(9, 4))
    else:
        X, X2 = _mixed_inputs(rng, 23, 9)
    jX, jX2 = jnp.asarray(X), jnp.asarray(X2)
    _close(tk.K(_t(X), _t(X2)), jk.K(jX, jX2))
    _close(tk.K(_t(X)), jk.K(jX))
    _close(tk.K_diag(_t(X)), jk.K_diag(jX))
    for dims in ([], [2], [0, 3], [1, 2, 3]):
        _close(tk.component_K(dims, _t(X), _t(X2)), jk.component_K(dims, jX, jX2))


@pytest.mark.parametrize("options", [
    dict(share_var_across_orders=False),
    dict(constrain_orthogonal=False),
    dict(active_dims=[[3], [0], [2], [1]]),
])
def test_oak_kernel_create_options_match_jax(options):
    """Same structure (every key and trainable flag) and the same gram for
    the constructor's other options."""
    jk, tk = _oak_pair("rbf", depth=2, **options)
    jk = _bridge(jk, tk, noise_seed=33)
    assert [(k, p.trainable) for k, p in tp.iter_params(tk)] == \
        [(k, p.trainable) for k, p in jp.iter_params(jk)]
    X = np.random.default_rng(34).normal(size=(11, 4))
    _close(tk.K(_t(X)), jk.K(jnp.asarray(X)))
    _close(tk.K_diag(_t(X)), jk.K_diag(jnp.asarray(X)))


def test_oak_kernel_rejects_bad_input():
    tk = OAKKernel.create(num_dims=3, **KW)
    with pytest.raises(ValueError, match="2-D"):
        tk.K(_t(np.zeros(3)))
    with pytest.raises(ValueError, match="columns"):
        tk.K(_t(np.zeros((4, 2))))
    with pytest.raises(ValueError, match="duplicates"):
        OAKKernel.create(num_dims=3, active_dims=[[0], [0], [1]], **KW)


def test_component_index_tuples_match_jax():
    assert component_index_tuples(5, 3) == j_component_index_tuples(5, 3)


# --------------------------------------------------------------------------- #
# Newton–Girard
# --------------------------------------------------------------------------- #
def test_newton_girard_matches_bruteforce_and_jax():
    rng = np.random.default_rng(35)
    grams = rng.normal(size=(5, 6, 7))
    depth = 4
    e = tng.newton_girard([_t(g) for g in grams], depth)
    brute = tng.elementary_symmetric_bruteforce([_t(g) for g in grams], depth)
    jax_e = j_newton_girard([jnp.asarray(g) for g in grams], depth)
    for n in range(depth + 1):
        _close(e[n], brute[n].numpy())
        _close(e[n], jax_e[n])
    s = tng.power_sums(iter([_t(g) for g in grams]), depth)
    for a, b in zip(s, j_power_sums([jnp.asarray(g) for g in grams], depth)):
        _close(a, b)
    with pytest.raises(ValueError):
        tng.newton_girard([], depth)
