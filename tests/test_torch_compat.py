"""oak_tpu_torch.compat, the reference-named surface, against oak_tpu.compat
on the CPU at float64 (the port's defaults set to float64 on the CPU, as the
reference's signatures name no device):

- every public name of the reference package resolves callable;
- each function agrees with oak_tpu's within 1e-10 relative: the L
  matrices (compute_L_binary_kernel's first-power variance kept), the
  sufficient statistics, the flow makers, the measure factories,
  OrthogonalRBFKernel, OAKKernel and Normalizer, compute_sobol_oak and
  get_prediction_component on a bridged model, f1..f4;
- save_model and load_model cross-load with oak_tpu.compat both ways;
- importing compat imports no matplotlib.
"""

import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.compat as jcompat
import oak_tpu.params as jp
import oak_tpu_torch
from oak_tpu.kernels import ortho_rbf as jrbf
from oak_tpu_torch import config
from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import ortho_rbf as trbf
from tests.test_torch_plotting import _Compiled
from tests.test_torch_regression import regression_pair

REL = 1e-10

# The public names of the reference package (tests/test_compat.py's list).
REFERENCE_NAMES = [
    "Measure", "UniformMeasure", "GaussianMeasure", "EmpiricalMeasure", "MOGMeasure",
    "OrthogonalRBFKernel", "OrthogonalBinary", "OrthogonalCategorical",
    "bounded_param", "OAKKernel", "KernelComponenent", "get_list_representation",
    "make_sinharcsinh", "make_standardizer", "Normalizer",
    "get_kmeans_centers", "save_model", "load_model", "create_model_oak",
    "apply_normalise_flow", "oak_model", "estimate_one_dim_gmm",
    "model_to_kernel_list", "extract_active_dims", "grammer_to_kernel",
    "f1", "f2", "f3", "f4", "get_model_sufficient_statistics",
    "compute_L", "compute_L_binary_kernel", "compute_L_categorical_kernel",
    "compute_L_empirical_measure", "compute_sobol_oak", "compute_sobol",
    "get_prediction_component", "initialize_kmeans_with_binary",
    "initialize_kmeans_with_categorical",
    "FigureDescription", "save_fig_list", "plot_single_effect",
    "plot_second_order", "plot_single_effect_binary",
    "plot_second_order_binary", "plot_single_effect_categorical",
]


@pytest.fixture
def compat(monkeypatch):
    """oak_tpu_torch.compat building in float64 on the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DTYPE", torch.float64)
    monkeypatch.setattr(config, "DEFAULT_DEVICE", torch.device("cpu"))
    return importlib.import_module("oak_tpu_torch.compat")


@pytest.fixture(scope="module")
def sgpr_pair(tmp_path_factory):
    return regression_pair(tmp_path_factory.mktemp("compat"), "sgpr")


# oak_tpu.compat calls oak_tpu.sobol's L builders eagerly, and eager JAX
# compiles every primitive at every shape; the references here run the same
# functions compiled, each once.
_COMPILED_SOBOL = types.SimpleNamespace(**{
    name: jax.jit(getattr(jcompat._sobol, name))
    for name in ("compute_L_gaussian", "compute_L_binary", "compute_L_categorical")})


_RBF_K = jax.jit(jrbf.K)


@pytest.fixture
def compiled_sobol(monkeypatch):
    monkeypatch.setattr(jcompat, "_sobol", _COMPILED_SOBOL)


def _close(ours, ref, rel=REL):
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * max(np.abs(ref).max(), 1e-300))


def test_every_reference_name_resolves_on_the_port(compat):
    missing = [n for n in REFERENCE_NAMES if not callable(getattr(compat, n, None))]
    assert not missing, f"compat surface missing: {missing}"
    assert set(REFERENCE_NAMES) <= set(dir(compat))


def test_compat_import_leaves_matplotlib_out(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # an import would raise
    monkeypatch.delitem(sys.modules, "oak_tpu_torch.compat", raising=False)
    monkeypatch.delattr(oak_tpu_torch, "compat", raising=False)
    fresh = importlib.import_module("oak_tpu_torch.compat")
    assert sys.modules["matplotlib"] is None
    assert callable(fresh.compute_sobol_oak) and "plot_second_order" in dir(fresh)


def test_compute_L_family_matches_oak_tpu(compat, compiled_sobol):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(14, 3))
    X[:, 0] = rng.integers(0, 2, 14)
    X[:, 2] = rng.integers(0, 3, 14)
    _close(compat.compute_L(X, 0.8, 1.3, 1, 1.0, 0.0), jcompat.compute_L(X, 0.8, 1.3, 1, 1.0, 0.0))
    for v in (1.0, 2.0):  # the reference's first-power variance
        _close(compat.compute_L_binary_kernel(X, 0.3, v, 0),
               jcompat.compute_L_binary_kernel(X, 0.3, v, 0))
    W, kappa, p = rng.uniform(size=(3, 2)), rng.uniform(0.5, 1.5, 3), np.array([0.2, 0.5, 0.3])
    _close(compat.compute_L_categorical_kernel(X, W, kappa, p, 1.7, 2),
           jcompat.compute_L_categorical_kernel(X, W, kappa, p, 1.7, 2))
    loc, w, z = np.linspace(-1, 1, 6), np.full(6, 1 / 6.0), rng.normal(size=10)
    tk = compat.OrthogonalRBFKernel(compat.RBF(1.4, 0.7), compat.EmpiricalMeasure(loc, w))
    jk = jcompat.OrthogonalRBFKernel(jcompat.RBF(1.4, 0.7), jcompat.EmpiricalMeasure(loc, w))
    _close(compat.compute_L_empirical_measure(loc, w, tk, z),
           jcompat.compute_L_empirical_measure(loc, w, jk, z))
    args = (0.3, -0.4, 1.2, 0.7, 1.1, 0.2)
    for name in ("f1", "f2", "f3", "f4"):
        _close(getattr(compat, name)(*args), getattr(jcompat, name)(*args))


def test_sufficient_statistics_sobol_and_components_match_oak_tpu(compat, sgpr_pair):
    jm, tm, X, _ = sgpr_pair
    alpha, L = compat.get_model_sufficient_statistics(tm)
    jalpha, jL = jcompat.get_model_sufficient_statistics(_Compiled(jm))
    _close(alpha, jalpha)
    _close(L, jL)
    _close(compat.get_model_sufficient_statistics(tm, get_L=False), jalpha)
    tuples, values = compat.compute_sobol_oak(tm, 1.0, 0.0)
    jtuples, jvalues = jcompat.compute_sobol_oak(jm, 1.0, 0.0)
    assert [list(t) for t in tuples] == [list(t) for t in jtuples]
    _close(values, jvalues)
    _close(compat.get_prediction_component(tm, alpha, X[:7]),
           jcompat.get_prediction_component(jm, jalpha, jnp.asarray(X[:7])))


def test_flow_makers_and_normalizer_match_oak_tpu(compat):
    rng = np.random.default_rng(12)
    x = rng.lognormal(size=40)
    ours, ref = compat.make_sinharcsinh(), jcompat.make_sinharcsinh()
    _close(ours["forward"](x), ref["forward"](x))
    _close(ours["tailweight"].value, ref["tailweight"].value)
    ours, ref = compat.make_standardizer(x), jcompat.make_standardizer(x)
    _close(ours["forward"](x), ref["forward"](x))
    for name in ("scale", "shift"):
        _close(ours[name].value, ref[name].value)
    tn, jn = compat.Normalizer(x, log=True), jcompat.Normalizer(x, log=True)
    _close(tn.forward(tn.as_input(x)), jn.forward(jnp.asarray(x)))
    _close(tn.KL_objective(x), jn.KL_objective(x))


def test_measure_and_kernel_factories_match_oak_tpu(compat):
    rng = np.random.default_rng(13)
    X, X2 = rng.normal(size=(8, 3)), rng.normal(size=(5, 3))
    X[:, 1], X2[:, 1] = rng.integers(0, 2, 8), rng.integers(0, 2, 5)
    pairs = [(compat.UniformMeasure(-1.0, 2.0), jcompat.UniformMeasure(-1.0, 2.0)),
             (compat.GaussianMeasure(0.3, 1.7), jcompat.GaussianMeasure(0.3, 1.7)),
             (compat.EmpiricalMeasure(X[:, 0]), jcompat.EmpiricalMeasure(X[:, 0])),
             (compat.MOGMeasure([-0.5, 0.5], [0.7, 1.3], [0.4, 0.6]),
              jcompat.MOGMeasure([-0.5, 0.5], [0.7, 1.3], [0.4, 0.6]))]
    for tm, jm in pairs:
        assert type(tm).__name__ == type(jm).__name__
        for name, buf in tm.named_buffers():
            _close(buf, getattr(jm, name))
        tk = compat.OrthogonalRBFKernel(compat.RBF(1.3, 0.8), tm, active_dims=[2])
        jk = jcompat.OrthogonalRBFKernel(jcompat.RBF(1.3, 0.8), jm, active_dims=[2])
        assert tk.active_dim == jk.active_dim == 2
        _close(trbf.K(tk, torch.as_tensor(X[:, 2]), torch.as_tensor(X2[:, 2])),
               _RBF_K(jk, jnp.asarray(X[:, 2]), jnp.asarray(X2[:, 2])))
    with pytest.raises(NotImplementedError):
        compat.OrthogonalRBFKernel(object(), pairs[1][0])
    kw = dict(num_dims=3, max_interaction_depth=2, constrain_orthogonal=True,
              p0=[None, 0.4, None], lengthscale_bounds=[1e-3, 1e3])
    tk, jk = compat.OAKKernel(None, **kw), jcompat.OAKKernel(None, **kw)
    _close(tk.K(torch.as_tensor(X), torch.as_tensor(X2)),
           jax.jit(lambda k, a, b: k.K(a, b))(jk, jnp.asarray(X), jnp.asarray(X2)))
    _close(tp.flatten_trainable(tk), jp.flatten_trainable(jk)[0])


def test_save_model_and_load_model_cross_load_with_oak_tpu(compat, sgpr_pair, tmp_path):
    jm, tm, _, _ = sgpr_pair
    jfresh, tfresh, _, _ = regression_pair(tmp_path, "sgpr", seed=99)
    compat.save_model(tm, tmp_path / "port.npz")
    jloaded = jcompat.load_model(jfresh, tmp_path / "port.npz")
    _close(jp.flatten_trainable(jloaded)[0], jp.flatten_trainable(jm)[0], 1e-12)
    jcompat.save_model(jm, tmp_path / "jax.npz")
    assert compat.load_model(tfresh, tmp_path / "jax.npz") is tfresh
    _close(tp.flatten_trainable(tfresh), tp.flatten_trainable(tm).detach(), 1e-12)
