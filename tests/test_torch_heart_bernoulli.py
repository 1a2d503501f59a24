"""The classification model of the UCI heart setting in float64 on the CPU,
at a small size: ``oak_model`` with binary, categorical and continuous
columns and the Bernoulli SVGP, held against the plain float64 reference
of ``benchmark/reference`` (``discrete.py``, ``svgp_bernoulli.py``); its 4
lanes batched against the lanes in turn; and the spans and counter that
only such a model opens (``oak.quad``, ``oak.extra``, ``gram.extra``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import discrete, svgp_bernoulli  # noqa: E402
from oak_tpu_torch import oak_model  # noqa: E402
from oak_tpu_torch.kernels import ortho_binary, ortho_categorical  # noqa: E402
from oak_tpu_torch.kernels.oak_kernel import OAKKernel  # noqa: E402
from oak_tpu_torch.models import SVGP, Gaussian  # noqa: E402
from oak_tpu_torch.ops import oak_gram as og  # noqa: E402
from oak_tpu_torch.optim import fit as tfit  # noqa: E402
from oak_tpu_torch.optim.multistart import _make_starts  # noqa: E402
from oak_tpu_torch.params import (assign_trainable, flatten_trainable,  # noqa: E402
                                  trainable_names, trainable_params)
from oak_tpu_torch.utils import profiling  # noqa: E402

KW = dict(dtype=torch.float64, device="cpu")
# 64 rows: columns 0 and 3 continuous, 1 binary, 2 categorical with 3 levels
CFG = {"num_dims": 4, "binary_feature": [1], "categorical_feature": [2],
       "categorical_levels": {"2": 3}, "categorical_rank": 2, "num_inducing": 16,
       "train_rows": 64, "max_interaction_depth": 3, "lengthscale_bounds": [1e-3, 1e3],
       "jitter": 1e-6, "order_variance_prior": [1.0, 0.2], "link_jitter": 1e-3,
       "num_gh": 20, "dtype": "float64"}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    n = CFG["train_rows"]
    X = np.zeros((n, 4))
    X[:, 0] = rng.normal(50.0, 9.0, n)
    X[:, 3] = rng.exponential(1.0, n)
    X[:, 1] = rng.uniform(size=n) < 0.4
    X[:, 2] = np.arange(n) % 3
    rng.shuffle(X[:, 2])
    logit = (X[:, 0] - 50.0) / 9.0 - X[:, 1] + (X[:, 2] == 1) + 0.5 * X[:, 3]
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-2.0 * logit))).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def heart():
    """The built, not optimised, ``oak_model`` and its rows."""
    X, y = _data()
    oak = oak_model(max_interaction_depth=3, num_inducing=16, binary_feature=[1],
                    categorical_feature=[2], likelihood="bernoulli", **KW)
    return oak.fit(X, y, optimise=False), X, y


def _k_card_route(self, X, X2=None):
    """OAKKernel.K through the card's route (``og._prep`` and ``og.fused_op``)
    on CPU tensors."""
    return og.fused_op(og._prep(self, X, X if X2 is None else X2), self.max_interaction_depth)


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(OAKKernel, "K", _k_card_route)


def _random_vec(model, seed):
    vec = flatten_trainable(model).detach().clone()
    return vec + 0.3 * torch.as_tensor(np.random.default_rng(seed).standard_normal(vec.shape[0]),
                                       **KW)


def _leaves(model, vec):
    """The vector as the reference's leaves (``variance`` one vector)."""
    out = {}
    sizes = [p.raw.numel() for p in trainable_params(model)]
    for name, piece in zip(trainable_names(model), torch.split(vec, sizes)):
        parts = name.split(".")
        if name.startswith("kernel.kernels."):
            out[f"{parts[3]}.{parts[2]}"] = piece.reshape(-1)
        elif name.startswith("kernel.variances."):
            out.setdefault("variance", []).append(piece.reshape(-1))
        else:
            out[parts[0]] = piece.reshape(-1)
    out["variance"] = torch.cat(out["variance"])
    return out


def test_the_binary_gram_is_the_reference_s_table():
    k = ortho_binary.OrthogonalBinary.create(p0=0.37, **KW)
    x = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0], **KW)
    x2 = torch.tensor([1.0, 0.0, 0.0], **KW)
    ref = discrete.table_gram(discrete.binary_table(torch.tensor(0.37, **KW)), x, x2)
    torch.testing.assert_close(ortho_binary.K(k, x, x2), ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ortho_binary.K_diag(k, x), torch.diagonal(
        discrete.table_gram(discrete.binary_table(torch.tensor(0.37, **KW)), x, x)),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("levels", [3, 4])
def test_the_categorical_gram_is_the_reference_s_constrained_table(levels):
    rng = np.random.default_rng(levels)
    p = rng.dirichlet(np.full(levels, 3.0))
    k = ortho_categorical.OrthogonalCategorical.create(p, **KW)
    with torch.no_grad():
        k.W.raw.copy_(torch.as_tensor(rng.normal(size=(levels, 2)), **KW))
        k.kappa.raw.copy_(torch.as_tensor(rng.normal(size=levels), **KW))
    x = torch.as_tensor(rng.integers(0, levels, 9), **KW)
    x2 = torch.as_tensor(rng.integers(0, levels, 5), **KW)
    B = discrete.categorical_table(k.W.value, k.kappa.value, torch.as_tensor(p, **KW))
    torch.testing.assert_close(ortho_categorical.K(k, x, x2), discrete.table_gram(B, x, x2),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ortho_categorical.K_diag(k, x), torch.diagonal(B)[x.long()],
                               rtol=1e-12, atol=1e-12)
    # orthogonal to constants under its measure
    assert float((B @ torch.as_tensor(p, **KW)).detach().abs().max()) < 1e-12


@pytest.mark.parametrize("route", ["grouped", "card"])
def test_the_mixed_oak_gram_is_the_reference_s(heart, route, monkeypatch):
    oak, _, _ = heart
    if route == "card":
        monkeypatch.setattr(OAKKernel, "K", _k_card_route)
    model = oak.m
    vec0 = flatten_trainable(model).detach().clone()
    vec = _random_vec(model, 1)
    X = torch.as_tensor(oak.X_scaled, **KW)
    Z = model.Z.value
    try:
        assign_trainable(model, vec)
        with torch.no_grad():
            K = model.kernel.K(Z, X)
            diag = model.kernel.K_diag(X)
    finally:
        assign_trainable(model, vec0)
    with torch.no_grad():
        ref = svgp_bernoulli.gram(CFG, X, Z, X, _leaves(model, vec))
        ls, B, sig2 = svgp_bernoulli._kernel(CFG, X, _leaves(model, vec))
        ref_diag = discrete.combine(discrete.dim_diags(X, ls, B), sig2)
    torch.testing.assert_close(K, ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(diag, ref_diag, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_the_bernoulli_bound_and_its_gradient_are_the_reference_s(heart, seed):
    oak, _, y = heart
    model = oak.m
    vec = _random_vec(model, seed)
    value, grad = tfit.value_and_grad(model, oak._loss_fn(), vec)
    X = torch.as_tensor(oak.X_scaled, **KW)
    leaves = {k: v.detach().requires_grad_(True) for k, v in _leaves(model, vec).items()}
    ref = svgp_bernoulli.loss(CFG, X, torch.as_tensor(y, **KW), model.Z.value, leaves)
    ref_grads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    torch.testing.assert_close(value, ref.detach(), rtol=1e-10, atol=0)
    prog = _leaves(model, grad)
    for name, g in ref_grads.items():
        torch.testing.assert_close(prog[name], g, rtol=1e-10, atol=1e-10 * float(g.abs().max()),
                                   msg=name)


def test_four_lanes_batched_match_the_lanes_in_turn(heart, card_route):
    oak, _, _ = heart
    model, loss_fn = oak.m, oak._loss_fn()
    starts = _make_starts(flatten_trainable(model).detach(), 4, 0.3, 5, True)
    values, grads = tfit.LaneLoss(model, loss_fn).value_and_grad(starts)
    for r in range(4):
        v, g = tfit.value_and_grad(model, loss_fn, starts[r])
        torch.testing.assert_close(values[r], v, rtol=1e-8, atol=0)
        torch.testing.assert_close(grads[r], g, rtol=1e-8, atol=1e-8 * float(g.abs().max()))


def test_the_quadrature_and_extra_grams_record_in_this_model(heart, card_route):
    oak, _, _ = heart
    model, loss_fn = oak.m, oak._loss_fn()
    starts = _make_starts(flatten_trainable(model).detach(), 4, 0.3, 5, True)
    with profiling.recording():
        tfit.LaneLoss(model, loss_fn).value_and_grad(starts)
    rec = profiling.record()
    names = {s.name for s in rec.spans}
    assert {"oak.quad", "oak.extra"} <= names
    # Kuu and Kuf, each with the binary and the categorical gram, 4 lanes
    assert rec.counters["gram.extra"] == 2 * 2 * 4
    assert rec.self_ms(["oak.quad"]) > 0 and rec.self_ms(["oak.extra"]) > 0


def test_nothing_of_them_records_in_a_continuous_gaussian_model(card_route):
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(24, 3)), **KW)
    Y = torch.sin(X[:, :1])
    model = SVGP.create(OAKKernel.create(num_dims=3, max_interaction_depth=2, **KW),
                        Gaussian.create(0.1, **KW), X[:8], num_data=24, **KW)
    starts = _make_starts(flatten_trainable(model).detach(), 4, 0.3, 5, True)
    with profiling.recording():
        tfit.LaneLoss(model, lambda m: m.training_loss(X, Y)).value_and_grad(starts)
    rec = profiling.record()
    names = {s.name for s in rec.spans}
    assert "oak.prep" in names
    assert not names & {"oak.quad", "oak.extra"}
    assert "gram.extra" not in rec.counters


def test_a_multistart_fit_runs_on_the_normal_path(heart):
    """``fit_lbfgs_multistart`` as ``oak_model._optimise_lbfgs`` calls it with
    restarts: 4 lanes warmed by Adam, the acceptance rule, a lower loss."""
    from oak_tpu_torch.optim.multistart import fit_lbfgs_multistart

    oak, _, _ = heart
    model, loss_fn = oak.m, oak._loss_fn()
    vec0 = flatten_trainable(model).detach().clone()
    try:
        with torch.no_grad():
            start = float(loss_fn(model))
        res = fit_lbfgs_multistart(
            model, loss_fn, n_starts=4, jitter=0.3, seed=0, max_iters=5, warm_adam_steps=3,
            include_init=True,
            accept_fn=lambda m: not (oak._degenerate_noise_fit(m) or oak._pathological_fit(m)))
        assert np.isfinite(res.fun) and res.fun < start
        with torch.no_grad():
            assert float(loss_fn(model)) == pytest.approx(res.fun, rel=1e-12)
    finally:
        assign_trainable(model, vec0)
