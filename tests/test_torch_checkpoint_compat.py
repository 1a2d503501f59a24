"""The reference-layout loader on the port (oak_tpu_torch.checkpoint
``reference_param_order`` / ``load_reference_npz``): the positional
``hyperparams`` npz of the reference's ``save_model``, GPflow's parameter
order, constrained values, with the cases of tests/test_checkpoint_compat.py
at float64 on the CPU; then one reference-layout file loaded into both
packages gives equal raw parameters and predictions within 1e-12."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.checkpoint as jckpt
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import GPR as JGPR
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Bernoulli as JBernoulli
from oak_tpu_torch import checkpoint as ckpt
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import GPR, SGPR, SVGP, Bernoulli

KW = dict(dtype=torch.float64, device="cpu")


def _value(p):
    return p.value.detach().numpy()


def _write_reference_npz(path, values):
    np.savez(path, hyperparams=np.asarray(values, dtype=object))


def _mixed_kernel(kernel_cls=OAKKernel, shared=True, **kw):
    """binary dim 0, categorical dim 1, Gaussian RBF dim 2, empirical dim 3."""
    loc = np.linspace(-1, 1, 5).reshape(-1, 1)
    w = np.full((5, 1), 0.2)
    return kernel_cls.create(
        num_dims=4, max_interaction_depth=2,
        p0=[0.4, None, None, None],
        p=[None, np.array([0.5, 0.2, 0.3]), None, None],
        empirical_locations=[None, None, None, loc],
        empirical_weights=[None, None, None, w],
        lengthscale_bounds=[1e-3, 1e3],
        share_var_across_orders=shared, **kw)


def _mixed_data(rng, n=20):
    X = rng.normal(size=(n, 4))
    X[:, 0] = rng.integers(0, 2, n)
    X[:, 1] = rng.integers(0, 3, n)
    return X, rng.normal(size=(n, 1))


def test_torch_reference_param_order_gpr_shared(rng):
    X, y = _mixed_data(rng)
    m = GPR.create(X, y, _mixed_kernel(**KW), noise_variance=0.01)
    # binary dim: variance pinned (absent); categorical: W, kappa; Gaussian
    # RBF: lengthscale only; empirical RBF: lengthscale + variance; the 3
    # order variances; the likelihood variance
    assert ckpt.reference_param_order(m) == [
        "kernels[1].W", "kernels[1].kappa",
        "kernels[2].lengthscale",
        "kernels[3].lengthscale", "kernels[3].variance",
        "variances[0]", "variances[1]", "variances[2]",
        "likelihood.variance",
    ]


def _gpr_values(rng):
    return [
        rng.uniform(0.1, 1.0, size=(3, 2)),      # W (unconstrained)
        rng.uniform(0.5, 2.0, size=(3,)),        # kappa (positive)
        np.float64(0.77),                        # lengthscale dim 2
        np.float64(1.31),                        # lengthscale dim 3
        np.float64(0.42),                        # base variance dim 3
        np.float64(0.9), np.float64(0.8), np.float64(0.7),  # order variances
        np.float64(0.013),                       # likelihood variance
    ]


def test_torch_load_reference_npz_gpr_roundtrip(rng, tmp_path):
    X, y = _mixed_data(rng)
    m = GPR.create(X, y, _mixed_kernel(**KW), noise_variance=0.01)
    before = copy.deepcopy(m)
    vals = _gpr_values(rng)
    path = tmp_path / "ref_gpr.npz"
    _write_reference_npz(path, vals)
    loaded = ckpt.load_reference_npz(m, path)
    assert loaded is m  # filled in place, as load_params does

    np.testing.assert_allclose(_value(loaded.kernel.kernels[1].W), vals[0])
    np.testing.assert_allclose(_value(loaded.kernel.kernels[1].kappa), vals[1], rtol=1e-12)
    assert float(_value(loaded.kernel.kernels[2].lengthscale)) == pytest.approx(0.77)
    assert float(_value(loaded.kernel.kernels[3].lengthscale)) == pytest.approx(1.31)
    assert float(_value(loaded.kernel.kernels[3].variance)) == pytest.approx(0.42)
    for j, v in enumerate([0.9, 0.8, 0.7]):
        assert float(_value(loaded.kernel.variances[j])) == pytest.approx(v)
    assert float(_value(loaded.likelihood.variance)) == pytest.approx(0.013)
    # untouched slots keep their values
    assert torch.equal(loaded.kernel.kernels[0].variance.raw,
                       before.kernel.kernels[0].variance.raw)


def _svgp_case(rng, d=3, M=6):
    Znew = rng.normal(size=(M, d))
    ls = [np.float64(v) for v in (0.5, 1.5, 2.5)]
    variances = [np.float64(v) for v in (1.1, 0.6, 0.2)]
    q_mu = rng.normal(size=(M, 1))
    q_sqrt = rng.uniform(0.5, 1.5, size=(M, 1))
    return rng.normal(size=(M, d)), [Znew] + ls + variances + [q_mu, q_sqrt]


def test_torch_load_reference_npz_svgp_all_params(rng, tmp_path):
    """An SVGP checkpoint holds ALL parameters, the fixed Z included
    (model_utils.py:54-57), and the variational q_mu / q_sqrt."""
    Z0, vals = _svgp_case(rng)
    k = OAKKernel.create(num_dims=3, max_interaction_depth=2,
                         lengthscale_bounds=[1e-3, 1e3], **KW)
    m = SVGP.create(k, Bernoulli.create("logit"), Z0, q_diag=True, whiten=True, num_data=50)
    path = tmp_path / "ref_svgp.npz"
    _write_reference_npz(path, vals)
    assert ckpt.reference_param_order(m) == [
        "Z",
        "kernels[0].lengthscale", "kernels[1].lengthscale", "kernels[2].lengthscale",
        "variances[0]", "variances[1]", "variances[2]",
        "q_mu", "q_sqrt",
    ]
    loaded = ckpt.load_reference_npz(m, path)
    np.testing.assert_allclose(_value(loaded.Z), vals[0])
    np.testing.assert_allclose(_value(loaded.q_mu), vals[7])
    np.testing.assert_allclose(_value(loaded.q_sqrt), vals[8], rtol=1e-12)
    for i, v in enumerate(vals[1:4]):
        assert float(_value(loaded.kernel.kernels[i].lengthscale)) == pytest.approx(float(v))


def test_torch_load_reference_npz_unshared_variance(rng, tmp_path):
    """Duvenaud mode: per-kernel base variances are parameters and only
    sigma^2_0 exists at the kernel level."""
    X, y = rng.normal(size=(15, 2)), rng.normal(size=(15, 1))
    k = OAKKernel.create(num_dims=2, max_interaction_depth=2, share_var_across_orders=False,
                         **KW)
    m = GPR.create(X, y, k, noise_variance=0.01)
    assert ckpt.reference_param_order(m) == [
        "kernels[0].lengthscale", "kernels[0].variance",
        "kernels[1].lengthscale", "kernels[1].variance",
        "variances[0]", "likelihood.variance",
    ]
    path = tmp_path / "ref_unshared.npz"
    _write_reference_npz(path, [np.float64(v) for v in (0.3, 0.7, 1.4, 2.1, 0.55, 0.02)])
    loaded = ckpt.load_reference_npz(m, path)
    assert float(_value(loaded.kernel.kernels[0].variance)) == pytest.approx(0.7)
    assert float(_value(loaded.kernel.variances[0])) == pytest.approx(0.55)
    assert float(_value(loaded.likelihood.variance)) == pytest.approx(0.02)


def test_torch_load_reference_npz_count_mismatch(rng, tmp_path):
    X, y = rng.normal(size=(10, 2)), rng.normal(size=(10, 1))
    m = GPR.create(X, y, OAKKernel.create(num_dims=2, max_interaction_depth=1, **KW),
                   noise_variance=0.01)
    path = tmp_path / "bad.npz"
    _write_reference_npz(path, [np.float64(1.0)])
    with pytest.raises(ValueError, match=r"expects 5: \['kernels\[0\].lengthscale'"):
        ckpt.load_reference_npz(m, path)


def test_torch_trainable_sgpr_z_slot(rng, tmp_path):
    """SGPR with a trainable Z (zfixed=False): Z leads the trainable list."""
    X, y = rng.normal(size=(12, 2)), rng.normal(size=(12, 1))
    k = OAKKernel.create(num_dims=2, max_interaction_depth=1, **KW)
    m = SGPR.create(X, y, k, X[:4].copy(), noise_variance=0.01, trainable_Z=True)
    assert ckpt.reference_param_order(m)[0] == "Z"
    Znew = rng.normal(size=(4, 2))
    path = tmp_path / "ref_sgpr.npz"
    _write_reference_npz(path, [Znew] + [np.float64(1.0)] * 4 + [np.float64(0.01)])
    np.testing.assert_allclose(_value(ckpt.load_reference_npz(m, path).Z), Znew)


def _both_gpr(rng):
    X, y = _mixed_data(rng, n=30)
    j = JGPR.create(X, y, _mixed_kernel(JOAKKernel), noise_variance=0.01)
    t = GPR.create(X, y, _mixed_kernel(**KW), noise_variance=0.01)
    return j, t, _gpr_values(rng), X


def _both_svgp(rng):
    Z0, vals = _svgp_case(rng)
    kw = dict(num_dims=3, max_interaction_depth=2, lengthscale_bounds=[1e-3, 1e3])
    j = JSVGP.create(JOAKKernel.create(**kw), JBernoulli.create("logit"), Z0, q_diag=True,
                     whiten=True, num_data=50)
    t = SVGP.create(OAKKernel.create(**kw, **KW), Bernoulli.create("logit"), Z0, q_diag=True,
                    whiten=True, num_data=50)
    return j, t, vals, rng.normal(size=(25, 3))


_JAX_PREDICT_F = jax.jit(lambda m, x: m.predict_f(x))


@pytest.mark.parametrize("case", [_both_gpr, _both_svgp], ids=["gpr_mixed", "svgp"])
def test_torch_reference_file_loads_alike_in_both_packages(rng, tmp_path, case):
    j, t, vals, Xnew = case(rng)
    path = tmp_path / "ref.npz"
    _write_reference_npz(path, vals)
    assert ckpt.reference_param_order(t) == jckpt.reference_param_order(j)
    j = jckpt.load_reference_npz(j, path)
    t = ckpt.load_reference_npz(t, path)
    jraw, traw = jckpt._flat_with_keys(j, "m"), ckpt._arrays(t, "m")
    assert sorted(traw) == sorted(jraw)
    for key, arr in jraw.items():
        np.testing.assert_allclose(traw[key], arr, rtol=1e-12, atol=1e-12, err_msg=key)
    # one compiled JAX program (eager dispatch compiles each primitive at
    # each shape)
    jmu, jvar = (np.asarray(a) for a in _JAX_PREDICT_F(j, jnp.asarray(Xnew)))
    with torch.no_grad():
        tmu, tvar = (a.numpy() for a in t.predict_f(torch.as_tensor(Xnew)))
    np.testing.assert_allclose(tmu, jmu, rtol=1e-12, atol=1e-12 * np.abs(jmu).max())
    np.testing.assert_allclose(tvar, jvar, rtol=1e-12, atol=1e-12 * np.abs(jvar).max())
