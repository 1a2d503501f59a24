"""oak_tpu_torch.plotting against oak_tpu.plotting on the CPU at float64, on
models bridged from oak_tpu:

- the posterior math: ``_component_posterior`` (order 1 on a continuous
  and on a binary dim, order 2) and ``_summed_order1_posterior`` on GPR,
  SGPR and SVGP pairs with mixed dims, within 1e-10 relative;
- the drawing: each of the five effect plots on the same bridged model in
  both packages has the same axes at the same positions, the same titles,
  labels and tick labels, and every line's, patch's and collection's data
  (bands, histograms, box plots, contours) within 1e-8 relative;
- ``plot_model`` on the committed heart fold 0 (an oak_model with binary
  and categorical dims) gives oak_tpu's titles in oak_tpu's order, and
  ``save_fig_list`` writes the same file names; ``plot_flow`` draws
  oak_tpu's figure.

Drawing runs on the CPU only (the card's machine has no matplotlib).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oak_tpu.flows as jflows
import oak_tpu.plotting as jplot
from oak_tpu_torch import flows as tflows
from oak_tpu_torch import plotting as tplot
from tests.test_torch_regression import regression_pair
from tests.test_torch_svgp import _model_pair
from tests.test_torch_uci_artifacts import committed_pair

REL, FIG_REL = 1e-10, 1e-8


# oak_tpu's plotting calls the per-dim grams, the posterior statistics and
# the OAK gram eagerly, and eager JAX compiles every primitive at every
# shape; the references here run the same functions compiled, each once.
_KERNEL_K, _KERNEL_K_DIAG = jax.jit(jplot.kernel_K), jax.jit(jplot.kernel_K_diag)


@pytest.fixture(autouse=True)
def _compiled_grams(monkeypatch):
    monkeypatch.setattr(jplot, "kernel_K", _KERNEL_K)
    monkeypatch.setattr(jplot, "kernel_K_diag", _KERNEL_K_DIAG)


class _Compiled:
    """oak_tpu's model with ``posterior_stats()`` and its kernel's ``K``
    compiled; every other attribute is the model's."""

    _stats = jax.jit(lambda m: m.posterior_stats())
    _gram = jax.jit(lambda k, a, b: k.K(a, b))

    def __init__(self, m):
        self._m = m
        self._posterior = _Compiled._stats(m)

    def posterior_stats(self):
        return self._posterior

    @property
    def kernel(self):
        return _CompiledKernel(self._m.kernel)

    def __getattr__(self, name):
        return getattr(self._m, name)


class _CompiledKernel:
    """An oak_tpu OAKKernel whose ``K`` is compiled."""

    def __init__(self, k):
        self._k = k

    def K(self, a, b):
        return _Compiled._gram(self._k, a, b)

    def __getattr__(self, name):
        return getattr(self._k, name)


def _compiled_oak(j):
    """oak_tpu's oak_model as plot_model sees it, with its Sobol ranking
    computed once by get_sobol and its model _Compiled."""
    j.get_sobol()
    ranked = copy.copy(j)
    ranked.m = _Compiled(j.m)
    ranked.get_sobol = lambda likelihood_variance=False: j.normalised_sobols
    return ranked


@pytest.fixture(scope="module", params=["gpr", "sgpr", "svgp"])
def mixed_pair(request, tmp_path_factory):
    """(oak_tpu model, port model) with dims 0 binary, 1 categorical, 2
    Gaussian, 3 empirical, 4 MOG (tests/test_torch_svgp._kernel_kwargs)."""
    tmp = tmp_path_factory.mktemp("plot")
    if request.param == "svgp":
        jm, tm, _, _ = _model_pair(tmp, mixed=True)
    else:
        jm, tm, _, _ = regression_pair(tmp, request.param, mixed=True)
    return _Compiled(jm), tm


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * max(np.abs(ref).max(), 1e-300))


def test_component_posteriors_match_oak_tpu(mixed_pair):
    jm, tm = mixed_pair
    grid = np.linspace(-1.8, 1.7, 11)
    cases = [([2], [grid]), ([4], [grid]), ([0], [np.array([0.0, 1.0])]),
             ([1], [np.arange(3.0)]),
             ([2, 0], [np.repeat(grid, 2), np.tile([0.0, 1.0], 11)]),
             ([2, 3], [grid, grid[::-1]])]
    for dims, cols in cases:
        mu, var = tplot._component_posterior(tm, dims, cols)
        jmu, jvar = jplot._component_posterior(jm, dims, cols)
        _close(mu, jmu)
        _close(var, jvar)
        assert (var >= 0).all()
    mu, var = tplot._summed_order1_posterior(tm, grid)
    jmu, jvar = jplot._summed_order1_posterior(jm, grid)
    _close(mu, jmu)
    _close(var, jvar)


# --------------------------------------------------------------------------- #
# Figures
# --------------------------------------------------------------------------- #
def _collection_data(c):
    paths = [p.vertices for p in c.get_paths()]
    return np.concatenate(paths) if paths else np.zeros((0, 2))


def _same_points(ours, ref, rel):
    """Every vertex of each set within rel of one of the other's. A contour
    line that passes through a grid point within rounding of its level may
    be split into two pieces there in one package and not in the other; the
    points are the same."""
    scale = max(np.abs(ref).max(), 1e-300) if ref.size else 1.0
    if not (ours.size or ref.size):
        return
    d = np.abs(ours[:, None, :] - ref[None, :, :]).max(axis=2)
    assert d.min(axis=1).max() <= rel * scale and d.min(axis=0).max() <= rel * scale


def assert_same_figure(ours, ref):
    """The same axes at the same positions with the same texts, and every
    line's, patch's and collection's data within FIG_REL."""
    oa, ra = ours.get_axes(), ref.get_axes()
    assert len(oa) == len(ra)
    for a, r in zip(oa, ra):
        np.testing.assert_allclose(a.get_position().bounds, r.get_position().bounds,
                                   rtol=0, atol=1e-12)
        for get in ("get_title", "get_xlabel", "get_ylabel", "get_xscale", "get_yscale"):
            assert getattr(a, get)() == getattr(r, get)(), get
        assert [t.get_text() for t in a.get_xticklabels()] == \
            [t.get_text() for t in r.get_xticklabels()]
        assert [t.get_visible() for t in a.get_xticklabels()] == \
            [t.get_visible() for t in r.get_xticklabels()]
        _close(a.get_xlim(), r.get_xlim(), FIG_REL)
        _close(a.get_ylim(), r.get_ylim(), FIG_REL)
        assert len(a.get_lines()) == len(r.get_lines())
        for la, lr in zip(a.get_lines(), r.get_lines()):
            _close(la.get_xydata(), lr.get_xydata(), FIG_REL)
            assert la.get_label() == lr.get_label()
        assert len(a.patches) == len(r.patches)
        if a.patches:
            _close([p.get_bbox().bounds for p in a.patches],
                   [p.get_bbox().bounds for p in r.patches], FIG_REL)
        assert [type(c).__name__ for c in a.collections] == \
            [type(c).__name__ for c in r.collections]
        for ca, cr in zip(a.collections, r.collections):
            if hasattr(cr, "levels"):  # a contour set: per level, its points
                _close(ca.levels, cr.levels, FIG_REL)
                for pa, pr in zip(ca.get_paths(), cr.get_paths()):
                    _same_points(pa.vertices, pr.vertices, FIG_REL)
            else:
                _close(_collection_data(ca), _collection_data(cr), FIG_REL)
        assert [t.get_text() for t in a.texts] == [t.get_text() for t in r.texts]


@pytest.fixture(scope="module")
def gpr_pair(tmp_path_factory):
    jm, tm, _, _ = regression_pair(tmp_path_factory.mktemp("fig"), "gpr", mixed=True)
    return _Compiled(jm), tm


PLOTS = {
    "single_effect": lambda P, m: P.plot_single_effect(
        m, 2, covariate_name="x2", title="t", plot_corrected_data=True,
        quantile_range=[5, 95], x_transform=lambda x: 2 * np.asarray(x) + 1),
    "latent_effect": lambda P, m: P.plot_single_effect(m, 5, covariate_name="lat",
                                                       plot_raw_data=True),
    "second_order": lambda P, m: P.plot_second_order(m, 2, 4, covariate_names=["a", "b"],
                                                     title="pair"),
    "single_effect_binary": lambda P, m: P.plot_single_effect_binary(
        m, 0, ["no", "yes"], covariate_name="flag", y_transform=lambda y: 3 * np.asarray(y)),
    "second_order_binary": lambda P, m: P.plot_second_order_binary(m, 3, 0, ["0", "1"],
                                                                   title="mix"),
    "single_effect_categorical": lambda P, m: P.plot_single_effect_categorical(
        m, 1, ["a", "b", "c"], title="cat"),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_effect_figure_matches_oak_tpus(gpr_pair, name):
    jm, tm = gpr_pair
    ours, ref = PLOTS[name](tplot, tm), PLOTS[name](jplot, jm)
    try:
        assert ours.description == ref.description
        assert_same_figure(ours.fig, ref.fig)
    finally:
        tplot._pyplot().close("all")


def test_plot_model_ranks_titles_and_files_like_oak_tpu(tmp_path):
    j, t, _, _ = committed_pair("heart", "classification")
    names = [f"c{i}/{i}" for i in range(t.num_dims)]  # '/' is replaced in file names
    ours = t.plot(X_columns=names, top_n=3, save_fig=tmp_path / "ours")
    ref = jplot.plot_model(_compiled_oak(j), X_columns=names, top_n=3)
    try:
        assert [f.description for f in ours] == [f.description for f in ref]
        assert len(ours) == 3
        for o, r in zip(ours, ref):
            assert_same_figure(o.fig, r.fig)
        # the names oak_tpu's save_fig_list gives its figures
        assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == \
            sorted(f.description.replace("/", "_") + ".pdf" for f in ref)
    finally:
        tplot._pyplot().close("all")


def test_plot_flow_draws_oak_tpus_figure():
    x = np.random.default_rng(9).lognormal(size=60)
    ours = tflows.Normalizer.create(x, log=True, dtype=torch.float64, device="cpu").plot(x, "f")
    ref = jflows.Normalizer.create(x, log=True, dtype=jnp.float64).plot(x, "f")
    try:
        assert_same_figure(ours, ref)
        assert tflows.plot_flow is not None
    finally:
        tplot._pyplot().close("all")
