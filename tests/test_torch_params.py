"""The port's bijectors, priors, Params and checkpoint bridge against oak_tpu
at float64. Inputs come from numpy seeds and cross between the packages as
numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.bijectors as jb
import oak_tpu.checkpoint as jckpt
import oak_tpu.params as jp
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu_torch import bijectors as tb
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import config
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Gaussian

REL = 1e-10  # f64: both packages evaluate the same formulas

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    """Agreement relative to the reference's largest magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


BIJECTORS = [
    ("identity", jb.Identity(), tb.Identity()),
    ("softplus", jb.Softplus(), tb.Softplus()),
    ("softplus_low", jb.Softplus(low=1e-6), tb.Softplus(low=1e-6)),
    ("exp", jb.Exp(), tb.Exp()),
    ("sigmoid_unit", jb.Sigmoid(), tb.Sigmoid()),
    ("sigmoid_ls_bounds", jb.Sigmoid(1e-3, 1e3), tb.Sigmoid(1e-3, 1e3)),
]


@pytest.mark.parametrize("name,jbij,tbij", BIJECTORS, ids=[b[0] for b in BIJECTORS])
def test_bijector_matches_jax_and_round_trips(name, jbij, tbij):
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(scale=3.0, size=40), [-30.0, 25.0, 0.0]])
    y_t = tbij.forward(_t(x))
    _close(y_t.numpy(), jbij.forward(jnp.asarray(x)))
    _close(tbij.inverse(y_t).numpy(), jbij.inverse(jbij.forward(jnp.asarray(x))),
           rel=1e-8)
    inner = x[np.abs(x) < 8]  # where the round trip is well conditioned
    _close(tbij.inverse(tbij.forward(_t(inner))).numpy(), inner, rel=1e-8)


PRIORS = [
    ("gamma_sparsity", jp.Gamma(1.0, 0.2), tp.Gamma(1.0, 0.2)),
    ("gamma_shaped", jp.Gamma(2.5, 0.7), tp.Gamma(2.5, 0.7)),
    ("normal", jp.Normal(0.3, 1.7), tp.Normal(0.3, 1.7)),
]


@pytest.mark.parametrize("name,jprior,tprior", PRIORS, ids=[p[0] for p in PRIORS])
def test_prior_log_prob_matches_jax(name, jprior, tprior):
    rng = np.random.default_rng(12)
    x = rng.uniform(0.01, 5.0, size=30)
    _close(tprior.log_prob(_t(x)).numpy(), jprior.log_prob(jnp.asarray(x)))


def test_gamma_sparsity_prior_finite_at_zero():
    # the a == 1 guard: no 0 * log(0) when a variance is pruned to 0
    assert torch.isfinite(tp.Gamma(1.0, 0.2).log_prob(torch.zeros(3, dtype=torch.float64))).all()


def test_defaults_resolve_to_the_card_in_float32():
    """None resolves to float32 on CUDA, as oak_tpu builds in float32 on its
    chip; an explicit CPU and dtype are kept; a built module lends its own.
    Resolving touches no card. Without one, building on the default device
    raises instead of falling back to the CPU."""
    assert config.resolve() == (torch.float32, torch.device("cuda"))
    assert config.resolve(torch.float64, "cpu") == (torch.float64, torch.device("cpu"))
    assert config.resolve(None, "cpu") == (torch.float32, torch.device("cpu"))
    f = tp.fixed(3.0, **KW)
    assert config.like(f) == (torch.float64, torch.device("cpu"))
    assert config.like(f, dtype=torch.float32) == (torch.float32, torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tp.positive(1.0)


def test_param_factories_and_prior_density():
    ls = tp.bounded(1e-3, 1e3, 2.5, **KW)
    assert abs(float(ls.value.detach()) - 2.5) < 1e-12
    v = tp.positive([0.5, 1.5], prior=tp.Gamma(2.0, 1.0), **KW)
    _close(v.value.detach().numpy(), [0.5, 1.5])
    jv = jp.positive(jnp.asarray([0.5, 1.5]), prior=jp.Gamma(2.0, 1.0))
    _close(v.log_prior_density().detach().numpy(), jv.log_prior_density())
    f = tp.fixed(3.0, **KW)
    assert not f.trainable and not f.raw.requires_grad
    assert float(f.log_prior_density()) == 0.0
    v.assign([2.0, 3.0])
    _close(v.value.detach().numpy(), [2.0, 3.0])


# --------------------------------------------------------------------------- #
# The checkpoint bridge
# --------------------------------------------------------------------------- #
N, D, M, DEPTH = 30, 3, 8, 2


def _models(q_diag=True):
    rng = np.random.default_rng(13)
    X = rng.normal(size=(N, D))
    Z = X[rng.choice(N, M, replace=False)]
    jk = JOAKKernel.create(num_dims=D, max_interaction_depth=DEPTH,
                           use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3],
                           dtype=jnp.float64)
    jm = JSVGP.create(jk, JGaussian.create(0.05, dtype=jnp.float64), Z,
                      num_data=N, q_diag=q_diag, dtype=jnp.float64)
    tk = OAKKernel.create(num_dims=D, max_interaction_depth=DEPTH,
                          use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3], **KW)
    tm = SVGP.create(tk, Gaussian.create(0.05, **KW), Z, num_data=N, q_diag=q_diag)
    return jm, tm


def _perturbed(jm, tmp_path):
    """jm with every trainable raw moved by seeded noise, saved to npz."""
    path = tmp_path / "jax_params.npz"
    jckpt.save_params(jm, path)
    rng = np.random.default_rng(14)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key in data:
        if key.endswith(".raw") and key != "m.Z.raw":
            data[key] = data[key] + rng.normal(scale=0.3, size=data[key].shape)
    np.savez(path, **data)
    return jckpt.load_params(jm, path), path


@pytest.mark.parametrize("q_diag", [True, False])
def test_load_jax_checkpoint_reads_identical_values(tmp_path, q_diag):
    jm, tm = _models(q_diag)
    jm, path = _perturbed(jm, tmp_path)
    tckpt.load_params(tm, str(path))
    jparams = jp.iter_params(jm)
    tparams = tp.iter_params(tm)
    assert [k for k, _ in tparams] == [k for k, _ in jparams]
    for (key, tparam), (_, jparam) in zip(tparams, jparams):
        # raws are the same bits; the constrained values differ by the last
        # ulp or two of the libraries' exp / log1p
        np.testing.assert_array_equal(tparam.raw.detach().numpy(),
                                      np.asarray(jparam.raw), err_msg=key)
        _close(tparam.value.detach().numpy(), jparam.value, rel=1e-14)
        assert tparam.trainable == jparam.trainable, key
    vec, _ = jp.flatten_trainable(jm)
    np.testing.assert_array_equal(tp.flatten_trainable(tm).detach().numpy(),
                                  np.asarray(vec))
    _close(tp.log_prior_density(tm).detach().numpy(), jp.log_prior_density(jm))


def test_port_checkpoint_loads_into_jax(tmp_path):
    jm, tm = _models()
    jm, path = _perturbed(jm, tmp_path)
    tckpt.load_params(tm, str(path))
    back = tmp_path / "torch_params.npz"
    tckpt.save_params(tm, back)
    jm2 = jckpt.load_params(jm, back)
    for a, b in zip(jax.tree_util.tree_leaves(jm2), jax.tree_util.tree_leaves(jm)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_key_mismatch_raises(tmp_path):
    jm, tm = _models()
    path = tmp_path / "p.npz"
    jckpt.save_params(jm, path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    assert "m.kernel.kernels[0].lengthscale.raw" in data
    missing = dict(data)
    del missing["m.q_mu.raw"]
    with pytest.raises(KeyError, match="m.q_mu.raw"):
        tckpt.load_params(tm, missing)
    extra = dict(data, **{"m.kernel.kernels[9].lengthscale.raw": np.zeros(())})
    with pytest.raises(KeyError, match="kernels\\[9\\]"):
        tckpt.load_params(tm, extra)
    wrong = dict(data, **{"m.q_mu.raw": np.zeros((M + 1, 1))})
    with pytest.raises(ValueError, match="q_mu"):
        tckpt.load_params(tm, wrong)
