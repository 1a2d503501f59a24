"""oak_tpu_torch.legacy, the Duvenaud-style product-kernel path, against
oak_tpu.legacy on the CPU at float64: ``grammer_to_kernel`` draws the same
hyperparameters into the same structure; the ``ProductKernel`` gram and
diagonal, the constant kernel and the legacy ``compute_sobol`` (with the
factors' own measures and with a Gaussian override) agree within 1e-10
relative; ``extract_active_dims`` and ``model_to_kernel_list`` give the
same dims and order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.legacy as jlegacy
import oak_tpu.measures as jmeas
from oak_tpu_torch import legacy
from oak_tpu_torch import measures as tmeas

KW = dict(dtype=torch.float64, device="cpu")
DIMS = [[0], [2], [0, 1], [1, 2, 3]]
REL = 1e-10
# oak_tpu.legacy builds each factor's L eagerly, and eager JAX compiles every
# primitive at every shape; the reference runs the same function compiled
_COMPILED_L = jax.jit(jlegacy.compute_L_for_kernel)


@pytest.fixture
def compiled_L(monkeypatch):
    monkeypatch.setattr(jlegacy, "compute_L_for_kernel", _COMPILED_L)


def _close(ours, ref, rel=REL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * np.abs(ref).max())


def _pair(measure):
    if measure == "gaussian":
        jm, tm = jmeas.GaussianMeasure.create(0.2, 1.5), tmeas.GaussianMeasure.create(0.2, 1.5, **KW)
    else:  # empirical: one location column per dim
        loc = np.random.default_rng(3).normal(size=(15, 4))
        jm = jmeas.EmpiricalMeasure.create(loc[:, 0])
        jm = jm.replace(location=jnp.asarray(loc))
        tm = tmeas.EmpiricalMeasure.create(loc[:, 0], **KW)
        tm.location = torch.as_tensor(loc)
    kw = dict(lengthscales_lo=0.3, lengthscales_hi=3.0, variance_lo=0.5, variance_hi=2.0)
    return (jlegacy.grammer_to_kernel(DIMS, 0, jm, seed=4, **kw),
            legacy.grammer_to_kernel(DIMS, 0, tm, seed=4, **kw, **KW))


@pytest.mark.parametrize("measure", ["gaussian", "empirical"])
def test_grammer_to_kernel_draws_oak_tpus_structure(measure):
    jks, tks = _pair(measure)
    assert len(tks) == len(jks) == len(DIMS) + 1
    assert isinstance(tks[-1], legacy.ConstantKernel)
    _close(tks[-1].variance.value, jks[-1].variance.value, 1e-14)
    assert legacy.extract_active_dims(tks) == jlegacy.extract_active_dims(jks) == DIMS
    for jk, tk in zip(jks[:-1], tks[:-1]):
        assert isinstance(tk, legacy.ProductKernel) and tk.active_dims == jk.active_dims
        for jf, tf in zip(jk.kernels, tk.kernels):
            assert type(tf.measure).__name__ == type(jf.measure).__name__
            for name in ("lengthscale", "variance"):
                jp, tp = getattr(jf, name), getattr(tf, name)
                assert tp.trainable == jp.trainable
                assert type(tp.bij).__name__ == type(jp.bij).__name__
                _close(tp.value, jp.value, 1e-14)


@pytest.mark.parametrize("measure", ["gaussian", "empirical"])
def test_product_kernel_gram_and_legacy_sobol_match_oak_tpu(measure, compiled_L):
    jks, tks = _pair(measure)
    rng = np.random.default_rng(6)
    X, X2 = rng.normal(size=(9, 4)), rng.normal(size=(6, 4))
    alpha = rng.normal(size=(9, 1))
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    # one compiled JAX program for every gram (eager dispatch compiles each
    # primitive at each shape)
    grams = jax.jit(lambda ks, A, B: [(k.K(A, B), k.K(A), k.K_diag(A)) for k in ks])
    for tk, ref in zip(tks, grams(jks, jnp.asarray(X), jnp.asarray(X2))):
        for ours, r in zip((tk.K(tX, tX2), tk.K(tX), tk.K_diag(tX)), ref):
            _close(ours, r)
    _close(legacy.compute_sobol(X, tks, alpha), jlegacy.compute_sobol(X, jks, alpha))
    if measure == "gaussian":
        _close(legacy.compute_sobol(tX, tks, torch.as_tensor(alpha), delta=0.7, mu=-0.1),
               jlegacy.compute_sobol(X, jks, alpha, delta=0.7, mu=-0.1))


def test_model_to_kernel_list_reorders_like_oak_tpu():
    jks, tks = _pair("gaussian")
    want = [[1, 2, 3], [0], [0, 1]]
    ours = legacy.model_to_kernel_list(tks, want)
    ref = jlegacy.model_to_kernel_list(jks, want)
    assert legacy.extract_active_dims(ours) == jlegacy.extract_active_dims(ref) == want
    assert isinstance(ours[-1], legacy.ConstantKernel) and len(ours) == len(ref) == 4
