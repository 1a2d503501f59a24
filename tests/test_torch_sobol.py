"""The port's Sobol layer against oak_tpu.sobol at float64: per-dim L
matrices and factor forms for every kernel and measure (rel 1e-10), the
closed-form/quadrature switch and the factor routing on both sides of
l = 0.5·√var, every component's Sobol value on SVGP, SGPR and GPR models
(the same tuples; values within rel 1e-9 of max |value|), the chunked
route, the per-order totals, the per-component predictions and
their sum-to-mean identity, normalize_sobol, the guards and select_latent.
Models are bridged from oak_tpu through the keypath npz (tests/
test_torch_regression.py, tests/test_torch_svgp.py)."""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import oak_tpu.checkpoint as jckpt
import oak_tpu.measures as jmeas
import oak_tpu.sobol as jsb
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.kernels import OrthogonalBinary as JOrthogonalBinary
from oak_tpu.kernels import OrthogonalCategorical as JOrthogonalCategorical
from oak_tpu.kernels import OrthogonalRBF as JOrthogonalRBF
from oak_tpu.models import GPR as JGPR
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu_torch import checkpoint as tckpt
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch import sobol as sb
from oak_tpu_torch.kernels import (OAKKernel, OrthogonalBinary, OrthogonalCategorical,
                                   OrthogonalRBF, get_list_representation)
from oak_tpu_torch.models import GPR, SVGP, Gaussian
from tests.test_torch_regression import regression_pair
from tests.test_torch_svgp import _close, _model_pair

L_REL = 1e-10
SOBOL_REL = 1e-9

# oak_tpu's L builders, compiled: called eagerly, JAX compiles every
# primitive at every shape, once per kernel and measure here
JL = SimpleNamespace(**{name: jax.jit(getattr(jsb, name)) for name in (
    "compute_L_for_kernel", "factor_form", "compute_L_quadrature", "compute_L_gaussian",
    "compute_L_binary", "compute_L_categorical", "compute_L_empirical")})

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close_max(a, b, rel):
    """|a - b| <= rel · max |b|, elementwise."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def _set_lengthscale(jm, tm, dim, value):
    """Dim ``dim``'s lengthscale set to ``value`` in both models, the port's
    raw copied from oak_tpu's bit for bit."""
    ks = list(jm.kernel.kernels)
    ks[dim] = ks[dim].replace(lengthscale=ks[dim].lengthscale.assign(value))
    jm = jm.replace(kernel=jm.kernel.replace(kernels=tuple(ks)))
    with torch.no_grad():
        tm.kernel.kernels[dim].lengthscale.raw.copy_(
            torch.as_tensor(np.array(ks[dim].lengthscale.raw)))
    return jm


MODELS = ["svgp", "svgp_mixed", "svgp_unwhitened", "sgpr", "sgpr_mixed", "gpr",
          "gpr_mixed", "gpr_nonfactor"]


@pytest.fixture(scope="module", params=MODELS)
def models(request, tmp_path_factory):
    """(jax_model, torch_model, X): ``*_nonfactor`` has dim 0's lengthscale
    at 0.05 (under 0.5·√var), so every order takes the ladder."""
    name = request.param
    path = tmp_path_factory.mktemp(name)
    mixed = name.endswith("mixed")
    if name.startswith("svgp"):
        jm, tm, X, _ = _model_pair(path, mixed=mixed, whiten=name != "svgp_unwhitened")
    else:
        jm, tm, X, _ = regression_pair(path, name.split("_")[0], mixed=mixed)
    if name.endswith("nonfactor"):
        jm = _set_lengthscale(jm, tm, 0, 0.05)
    return jm, tm, X


def test_sobol_values_match_jax(models):
    jm, tm, _ = models
    tuples, vals = sb.compute_sobol_oak(tm)
    jtuples, jvals = jsb.compute_sobol_oak(jm)
    assert tuples == jtuples
    assert sb._factor_routing(tm.kernel) == jsb._factor_routing(jm.kernel)
    _close_max(vals, jvals, SOBOL_REL)
    assert np.all(vals > 0)


def test_sobol_by_order_matches_jax_and_component_sums(models):
    jm, tm, _ = models
    by_order = sb.compute_sobol_by_order(tm)
    _close_max(by_order, jsb.compute_sobol_by_order(jm), SOBOL_REL)
    tuples, vals = sb.compute_sobol_oak(tm)
    sums = np.zeros(len(by_order))
    for t, v in zip(tuples, vals):
        sums[len(t) - 1] += v
    np.testing.assert_allclose(by_order, sums, rtol=1e-9)


def test_prediction_components_match_jax_and_sum_to_mean(models):
    jm, tm, X = models
    Xs = X[:9]
    comps = sb.get_prediction_component(tm, X=torch.as_tensor(Xs))
    _close_max(comps, jsb.get_prediction_component(jm, X=jnp.asarray(Xs)), SOBOL_REL)
    with torch.no_grad():
        alpha = tm.posterior_alpha()[:, 0]
        constant = float(alpha.sum() * tm.kernel.variances[0].value)
        mean = tm.predict_f(torch.as_tensor(Xs))[0][:, 0].numpy()
    _close_max(comps.sum(axis=0) + constant, mean, 1e-9)


def test_depth_truncation_matches_jax(models):
    jm, tm, X = models
    for depth in (1, 2):
        tuples, vals = sb.compute_sobol_oak(tm, max_interaction_depth=depth)
        jtuples, jvals = jsb.compute_sobol_oak(jm, max_interaction_depth=depth)
        assert tuples == jtuples and max(len(t) for t in tuples) == depth
        _close_max(vals, jvals, SOBOL_REL)


# --------------------------------------------------------------------------- #
# The ladder's other routes
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def nonfactor_gpr(tmp_path_factory):
    jm, tm, _, _ = regression_pair(tmp_path_factory.mktemp("nf"), "gpr")
    jm = _set_lengthscale(jm, tm, 0, 0.05)
    assert not all(sb._factor_routing(tm.kernel))
    return tm, jsb.compute_sobol_oak(jm)[1]


@pytest.mark.parametrize("cap", ["all_orders", "from_order_3"])
def test_chunked_route_under_lowered_cap(nonfactor_gpr, monkeypatch, cap):
    """A cap of 1 byte sends every order to the chunked route; a cap of one
    [D, N²] prefix matrix keeps orders 1-2 on the ladder and chunks order
    3."""
    tm, jvals = nonfactor_gpr
    D, N = tm.kernel.num_dims, tm.X.shape[0]
    monkeypatch.setattr(sb, "_LADDER_BYTES_CAP", 1 if cap == "all_orders" else D * N * N * 8)
    _, vals = sb.compute_sobol_oak(tm)
    _close_max(vals, jvals, SOBOL_REL)


# --------------------------------------------------------------------------- #
# L matrices, factor forms and routing
# --------------------------------------------------------------------------- #
def _routings(jks, tks):
    """``_factor_routing`` of an OAKKernel over the given constituent
    kernels: (the port's, oak_tpu's)."""
    jbase = JOAKKernel.create(num_dims=len(jks), dtype=jnp.float64)
    tbase = OAKKernel.create(num_dims=len(tks), **KW)
    return (sb._factor_routing(OAKKernel(tks, list(tbase.variances))),
            jsb._factor_routing(jbase.replace(kernels=tuple(jks))))


@pytest.fixture(scope="module")
def mixed_kernels(tmp_path_factory):
    """Kernel pairs of the bridged mixed model (binary, categorical,
    Gaussian, empirical, MOG), plus a uniform-measure RBF pair."""
    jm, tm, X, _ = _model_pair(tmp_path_factory.mktemp("mk"), mixed=True)
    pairs = [(jk, tk, X[:, jk.active_dim]) for jk, tk in zip(jm.kernel.kernels,
                                                            tm.kernel.kernels)]
    ju = JOrthogonalRBF.create(jmeas.UniformMeasure.create(-1.0, 2.0), lengthscale=0.9,
                               variance=1.1, dtype=jnp.float64)
    tu = OrthogonalRBF.create(tmeas.UniformMeasure.create(-1.0, 2.0, **KW), lengthscale=0.9,
                              variance=1.1)
    return pairs + [(ju, tu, np.linspace(-1.5, 2.5, 11))]


KERNEL_IDS = ["binary", "categorical", "gaussian", "empirical", "mog", "uniform"]


@pytest.mark.parametrize("i", range(len(KERNEL_IDS)), ids=KERNEL_IDS)
def test_L_and_factor_form_match_jax(mixed_kernels, i):
    jk, tk, x = mixed_kernels[i]
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    _close(sb.compute_L_for_kernel(tk, tx), JL.compute_L_for_kernel(jk, jx), L_REL)
    (F, w), (jF, jw) = sb.factor_form(tk, tx), JL.factor_form(jk, jx)
    _close(F, jF, L_REL)
    _close(w, jw, L_REL)
    assert _routings([jk], [tk]) == ((True,), (True,))
    if KERNEL_IDS[i] in ("gaussian", "mog", "uniform"):
        _close(sb.compute_L_quadrature(tk, tx), JL.compute_L_quadrature(jk, jx), L_REL)
    for name in ("binary", "categorical", "empirical"):
        if KERNEL_IDS[i] == name:
            fn, jfn = getattr(sb, f"compute_L_{name}"), getattr(JL, f"compute_L_{name}")
            _close(fn(tk, tx), jfn(jk, jx), L_REL)


RATIOS = (0.2, 0.35, 0.49, 0.5, 0.51, 0.8, 1.5, 40.0)
DELTA, MU = 1.3, 0.2


def _gaussian_pair(ratio, dtype=torch.float64):
    """One OrthogonalRBF under N(0.2, 1.3²) with l = ratio·1.3 in both
    packages."""
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jk = JOrthogonalRBF.create(jmeas.GaussianMeasure.create(MU, DELTA ** 2, dtype=jdtype),
                               lengthscale=ratio * DELTA, variance=1.2, dtype=jdtype)
    tk = OrthogonalRBF.create(tmeas.GaussianMeasure.create(MU, DELTA ** 2, dtype=dtype,
                                                           device="cpu"),
                              lengthscale=ratio * DELTA, variance=1.2)
    return jk, tk


@pytest.mark.parametrize("ratio", RATIOS)
def test_gaussian_switch_and_routing_match_jax(ratio):
    """Across the switch at l = 0.5·√var under N(0.2, 1.3²): the routed L,
    both branches, the measure-override branch and the factor routing equal
    oak_tpu's; the routing flips at the switch."""
    delta, mu = DELTA, MU
    jk, tk = _gaussian_pair(ratio)
    x = np.linspace(-1.6, 1.6, 7)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    _close(sb.compute_L_for_kernel(tk, tx), JL.compute_L_for_kernel(jk, jx), L_REL)
    _close(sb.compute_L_for_kernel(tk, tx, delta=1.0, mu=0.0),
           JL.compute_L_for_kernel(jk, jx, delta=1.0, mu=0.0), L_REL)
    _close(sb.compute_L_quadrature(tk, tx), JL.compute_L_quadrature(jk, jx), L_REL)
    if ratio < 10:  # the closed form cancels to noise at large l in both packages
        _close(sb.compute_L_gaussian(tx, tk.lengthscale.value, 1.2, delta, mu),
               JL.compute_L_gaussian(jx, jk.lengthscale.value, 1.2, delta, mu), L_REL)
    assert _routings([jk], [tk]) == ((ratio > 0.5,), (ratio > 0.5,))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_factor_routing_straddling_the_switch_matches_jax(dtype):
    """One OAKKernel whose Gaussian dims lie on both sides of l = 0.5·√var,
    with a binary and a categorical dim among them: the port's decision,
    read in one transfer, equals oak_tpu's dim for dim."""
    pairs = [_gaussian_pair(r, dtype) for r in RATIOS]
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    pairs.insert(2, (JOrthogonalBinary.create(0.3, dtype=jdtype),
                     OrthogonalBinary.create(0.3, dtype=dtype, device="cpu")))
    pairs.insert(5, (JOrthogonalCategorical.create([0.2, 0.5, 0.3], dtype=jdtype),
                     OrthogonalCategorical.create([0.2, 0.5, 0.3], dtype=dtype,
                                                   device="cpu")))
    routing, jrouting = _routings([j for j, _ in pairs], [t for _, t in pairs])
    assert routing == jrouting
    expect = [r > 0.5 for r in RATIOS]
    expect.insert(2, True)
    expect.insert(5, True)
    assert routing == tuple(expect)


def test_closed_form_loses_f32_where_quadrature_holds():
    """Why the switch: at l = 40 the f32 closed form's relative error is
    above 1e-2, while quadrature stays within 1e-6 of the f64 closed form."""
    k = OrthogonalRBF.create(tmeas.GaussianMeasure.create(0.0, 1.0, **KW), lengthscale=40.0,
                             variance=1.0)
    x = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    L64 = sb.compute_L_gaussian(x, 40.0, 1.0, 1.0, 0.0)
    L32 = sb.compute_L_gaussian(x.float(), 40.0, 1.0, 1.0, 0.0).double()
    Lq = sb.compute_L_quadrature(k, x).detach()
    assert (Lq - L64).abs().max() <= 1e-6 * L64.abs().max()
    assert (L32 - L64).abs().max() > 1e-2 * L64.abs().max()


def test_kernel_components_match_jax(tmp_path):
    """component_K / component_K_diag through get_list_representation."""
    from oak_tpu.kernels import get_list_representation as jget

    jm, tm, X, _ = _model_pair(tmp_path, mixed=True)
    Xa, Xb = X[:7], X[7:12]
    dims, comps = get_list_representation(tm.kernel, 5)
    jdims, jcomps = jget(jm.kernel, 5)
    assert dims == jdims and len(comps) == len(jcomps) == 26
    for c, jc in zip(comps, jcomps):
        _close(c.K(torch.as_tensor(Xa), torch.as_tensor(Xb)), jc.K(Xa, Xb), L_REL)
        _close(c.K_diag(torch.as_tensor(Xa)), jc.K_diag(Xa), L_REL)
        assert [k.active_dim for k in c.kernels] == [k.active_dim for k in jc.kernels]


# --------------------------------------------------------------------------- #
# normalize_sobol, guards, latents
# --------------------------------------------------------------------------- #
def test_normalize_sobol_matches_jax():
    v = np.array([0.5, 1.5, 0.25])
    np.testing.assert_array_equal(sb.normalize_sobol(v), jsb.normalize_sobol(v))
    np.testing.assert_array_equal(sb.normalize_sobol(v, 0.3), jsb.normalize_sobol(v, 0.3))
    for bad in (np.zeros(3), np.array([1.0, np.nan])):
        with pytest.warns(RuntimeWarning, match="zero or non-finite"):
            out = sb.normalize_sobol(bad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            np.testing.assert_array_equal(out, jsb.normalize_sobol(bad))


def _gpr_pair(X, Y, **kw):
    return (JGPR.create(X, Y, JOAKKernel.create(**kw, dtype=jnp.float64), noise_variance=0.1),
            GPR.create(X, Y, OAKKernel.create(**kw, **KW), noise_variance=0.1))


def test_guards_raise_like_jax():
    rng = np.random.default_rng(90)
    X = rng.normal(size=(12, 3))
    jm, tm = _gpr_pair(X, X[:, :1], num_dims=3, max_interaction_depth=2)
    cases = [
        (NotImplementedError, dict(delta=2.0, mu=0.0)),  # measure override
        (NotImplementedError, dict(delta=1.0, mu=1.0)),
        (ValueError, dict(max_interaction_depth=3)),  # above the model's depth
        (ValueError, dict(max_interaction_depth=-1)),
    ]
    for exc, kw in cases:
        with pytest.raises(exc):
            jsb.compute_sobol_oak(jm, **kw)
        with pytest.raises(exc):
            sb.compute_sobol_oak(tm, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        sb.compute_sobol_by_order(tm, max_depth=3)
    with pytest.raises(ValueError, match="exceeds"):
        sb.get_prediction_component(tm, X=torch.as_tensor(X), max_interaction_depth=3)
    # a matching override, and depth 0 meaning the model's own
    t_full, v_full = sb.compute_sobol_oak(tm)
    t0, v0 = sb.compute_sobol_oak(tm, delta=1.0, mu=0.0, max_interaction_depth=0)
    assert t0 == t_full and len(t0) == 6
    np.testing.assert_array_equal(v0, v_full)
    np.testing.assert_array_equal(sb.compute_sobol_by_order(tm, max_depth=0),
                                  sb.compute_sobol_by_order(tm))
    # the unconstrained kernel has no L
    jm_u, tm_u = _gpr_pair(X, X[:, :1], num_dims=3, max_interaction_depth=2,
                           constrain_orthogonal=False)
    with pytest.raises(NotImplementedError):
        jsb.compute_sobol_oak(jm_u)
    with pytest.raises(NotImplementedError):
        sb.compute_sobol_oak(tm_u)


def test_unknown_measure_routes_to_hadamard_and_raises():
    class _FakeMeasure(nn.Module):
        pass

    oak = OAKKernel.create(num_dims=2, max_interaction_depth=2, **KW)
    assert sb._factor_routing(oak) == (True, True)
    oak.kernels[0].measure = _FakeMeasure()
    assert not sb._has_factor_form(oak.kernels[0])
    assert sb.factor_form(oak.kernels[0], torch.zeros(3)) is None
    assert sb._factor_routing(oak) == (False, True)
    X = torch.as_tensor(np.random.default_rng(91).normal(size=(10, 2)))
    with pytest.raises(NotImplementedError):
        sb.compute_sobol_oak(GPR.create(X, X[:, :1], oak, noise_variance=0.1))


def _svgp_pair(tmp_path, q_diag):
    """A two-latent SVGP in both packages with distinct q per latent."""
    rng = np.random.default_rng(92)
    X = rng.normal(size=(16, 2))
    kw = dict(num_dims=2, max_interaction_depth=2)
    jm = JSVGP.create(JOAKKernel.create(**kw, dtype=jnp.float64),
                      JGaussian.create(0.1, dtype=jnp.float64), X[:8], num_latent=2,
                      q_diag=q_diag, dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**kw, **KW), Gaussian.create(0.1, **KW), X[:8],
                     num_latent=2, q_diag=q_diag)
    path = tmp_path / "latents.npz"
    jckpt.save_params(jm, path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    data["m.q_mu.raw"] = rng.normal(size=data["m.q_mu.raw"].shape)
    data["m.q_sqrt.raw"] = data["m.q_sqrt.raw"] + (
        rng.uniform(size=data["m.q_sqrt.raw"].shape) if q_diag
        else np.tril(rng.normal(scale=0.2, size=data["m.q_sqrt.raw"].shape)))
    np.savez(path, **data)
    jm = jckpt.load_params(jm, path)
    tckpt.load_params(tm, str(path))
    return jm, tm, X


@pytest.mark.parametrize("kind", ["svgp_q_diag", "svgp_full_q", "gpr_two_outputs"])
def test_select_latent_matches_jax(tmp_path, kind):
    if kind == "gpr_two_outputs":
        jm, tm, X, _ = regression_pair(tmp_path, "gpr", outputs=2)
        X = X[:9]
    else:
        jm, tm, X = _svgp_pair(tmp_path, q_diag=kind == "svgp_q_diag")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert sb.num_latents(tm) == jsb.num_latents(jm) == 2
    with pytest.raises(NotImplementedError, match="latent"):
        sb.compute_sobol_oak(tm)
    with pytest.raises(NotImplementedError, match="latent"):
        sb.check_single_latent(tm)
    with pytest.raises(ValueError, match="out of range"):
        sb.compute_sobol_oak(tm, latent=2)
    outs = []
    for r in (0, 1):
        tuples, vals = sb.compute_sobol_oak(tm, latent=r)
        jtuples, jvals = jsb.compute_sobol_oak(jm, latent=r)
        assert tuples == jtuples
        _close_max(vals, jvals, SOBOL_REL)
        _close_max(sb.compute_sobol_by_order(tm, latent=r),
                   jsb.compute_sobol_by_order(jm, latent=r), SOBOL_REL)
        _close_max(sb.get_prediction_component(tm, X=torch.as_tensor(X), latent=r),
                   jsb.get_prediction_component(jm, X=jnp.asarray(X), latent=r),
                   SOBOL_REL)
        view = sb.select_latent(tm, r)
        assert sb.num_latents(view) == 1 and view.kernel is tm.kernel
        with torch.no_grad():
            mu_view = view.predict_f(torch.as_tensor(X))[0][:, 0]
            mu_full = tm.predict_f(torch.as_tensor(X))[0][:, r]
        _close(mu_view, mu_full.numpy(), 1e-12)
        outs.append(vals)
    assert not np.allclose(outs[0], outs[1])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
