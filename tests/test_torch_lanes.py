"""The multistart's lanes as one batched program (oak_tpu_torch.optim and
ops.oak_gram), at float64 on the CPU:

- ``torch.func.vmap`` over ``FusedGram`` and the registered ops at R = 3
  equals per-lane calls (value and every cotangent within 1e-12), with
  inputs shared by every lane (in_dims None) and extra grams; each op's
  plain version is entered once per vmapped call, not once per lane;
- ``fit.LaneLoss`` (vmap of grad_and_value over the flat trainable vector)
  of the SVGP (q_diag and full q; Gaussian and Bernoulli), SGPR and GPR
  losses equals per-lane ``fit.value_and_grad`` within 1e-12, on the plain
  route and through the registered ops;
- the lane-batched L-BFGS (``fit.lbfgs_lanes``) over 20 iterations equals
  R = 1 runs from the same starts within 1e-10, with lanes that stop at
  different iterations and one whose loss is not finite, and makes one
  evaluation per linesearch step for all the lanes still searching;
- a multistart checkpoint written by the lanes-in-turn multistart (the
  committed tests/data/lbfgs_multistart_in_turn.npz, 3 lanes, 4 of 8
  iterations) loads and resumes to the uninterrupted batched result, and
  the batched multistart writes the same layout;
- the vmapped natural-gradient step equals the single-start
  ``natgrad_adam_step`` lane by lane.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import GPR, SGPR, SVGP, Bernoulli, Gaussian
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.optim import fit as tfit
from oak_tpu_torch.optim import multistart as tms
from oak_tpu_torch.optim import natgrad as tng
from oak_tpu_torch.testing import LANE_NAMES, lane_inputs
from tests.test_torch_lbfgs import _gpr

KW = dict(dtype=torch.float64, device="cpu")
R, DEPTH = 3, 3
PARENT_CHECKPOINT = Path(__file__).parent / "data" / "lbfgs_multistart_in_turn.npz"


def _close(a, b, rel):
    a, b = (t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of entries into the two plain versions."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = og.oak_gram_plain, og.oak_gram_bwd_plain

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(og, "oak_gram_plain", count("fwd", fwd))
    monkeypatch.setattr(og, "oak_gram_bwd_plain", count("bwd", bwd))
    return calls


def _lane_args(shared):
    args = [t.double() for t in lane_inputs(5, R, 3, 6, 5, 2, DEPTH, "cpu", shared=shared)]
    return args, tuple(None if name in shared else 0 for name in LANE_NAMES)


def _lane(args, dims, r):
    return [a if d is None else a[r] for a, d in zip(args, dims)]


SHARED = [(), ("u2", "c2"), ("extra", "sig2")]


@pytest.mark.parametrize("shared", SHARED, ids=["none", "u2,c2", "extra,sig2"])
def test_vmapped_fused_gram_equals_per_lane_calls(plain_calls, shared):
    args, dims = _lane_args(shared)
    gbar = torch.as_tensor(np.random.default_rng(9).normal(size=(R, 6, 5)))

    def loss(*a):
        *x, g = a
        return (og.FusedGram.apply(*x, DEPTH) * g).sum()

    grads, values = torch.func.vmap(torch.func.grad_and_value(loss, argnums=tuple(range(7))),
                                    in_dims=dims + (0,))(*args, gbar)
    assert plain_calls == {"fwd": 1, "bwd": 1}
    for r in range(R):
        x = [t.clone().requires_grad_(True) for t in _lane(args, dims, r)]
        value = (og.oak_gram_plain(*x, DEPTH) * gbar[r]).sum()
        _close(values[r], value, 1e-12)
        for got, want in zip(grads, torch.autograd.grad(value, x)):
            _close(got[r], want, 1e-12)


@pytest.mark.parametrize("shared", SHARED, ids=["none", "u2,c2", "extra,sig2"])
def test_vmapped_registered_ops_equal_per_lane_calls(plain_calls, shared):
    args, dims = _lane_args(shared)
    gbar = torch.as_tensor(np.random.default_rng(10).normal(size=(R, 6, 5)))
    out = torch.vmap(og.oak_gram_fwd_op, in_dims=dims + (None,))(*args, DEPTH)
    grads = torch.vmap(lambda *a: og.oak_gram_bwd_op(*a, DEPTH, False),
                       in_dims=dims + (0,))(*args, gbar)
    assert plain_calls == {"fwd": 1, "bwd": 1}
    assert grads[4].numel() == 0
    for r in range(R):
        lane = _lane(args, dims, r)
        _close(out[r], og.oak_gram_fwd_op(*lane, DEPTH), 1e-12)
        want = og.oak_gram_bwd_op(*lane, gbar[r], DEPTH, True)
        for k in (0, 1, 2, 3, 5, 6):
            _close(grads[k][r], want[k], 1e-12)
    assert plain_calls == {"fwd": 1 + R, "bwd": 1 + R}


def _data(n=24, d=3, seed=0, binary=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    if binary:
        return X, (y > 0).astype(np.float64)[:, None]
    return X, y[:, None]


def _kernel(d=3):
    return OAKKernel.create(num_dims=d, max_interaction_depth=DEPTH, **KW)


def _svgp(q_diag, likelihood):
    X, Y = _data(binary=likelihood == "bernoulli")
    lik = Gaussian.create(0.1, **KW) if likelihood == "gaussian" else Bernoulli.create()
    m = SVGP.create(_kernel(), lik, X[:8], q_diag=q_diag, num_data=len(X), **KW)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    return m, lambda mm: mm.training_loss(Xt, Yt)


def _sgpr():
    X, Y = _data()
    return SGPR.create(X, Y, _kernel(), X[:8], noise_variance=0.1, **KW), \
        lambda m: m.training_loss()


def _gpr_model():
    X, Y = _data(n=16)
    return GPR.create(X, Y, _kernel(), noise_variance=0.1, **KW), lambda m: m.training_loss()


MODELS = {"svgp q_diag gaussian": lambda: _svgp(True, "gaussian"),
          "svgp full-q bernoulli": lambda: _svgp(False, "bernoulli"),
          "svgp full-q gaussian": lambda: _svgp(False, "gaussian"),
          "sgpr": _sgpr, "gpr": _gpr_model}


def _k_through_ops(self, X, X2=None):
    """OAKKernel.K through the registered ops, as on the card, on CPU tensors."""
    inputs = og._prep(self, X, X if X2 is None else X2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return og.FusedGram.apply(*inputs, self.max_interaction_depth)
    return og.oak_gram_fwd_op(*inputs, self.max_interaction_depth)


@pytest.mark.parametrize("route", ["plain", "ops"])
@pytest.mark.parametrize("name", list(MODELS))
def test_lane_loss_equals_per_lane_value_and_grad(monkeypatch, plain_calls, name, route):
    if route == "ops":
        monkeypatch.setattr(OAKKernel, "K", _k_through_ops)
    model, loss_fn = MODELS[name]()
    vec0 = tp.flatten_trainable(model).detach()
    vecs = tms._make_starts(vec0, R, 0.3, 1, True)
    values, grads = tfit.LaneLoss(model, loss_fn).value_and_grad(vecs)
    batched = dict(plain_calls)
    for r in range(R):
        value, grad = tfit.value_and_grad(model, loss_fn, vecs[r])
        _close(values[r], value, 1e-12)
        _close(grads[r], grad, 1e-12)
    _close(tfit.LaneLoss(model, loss_fn).values(vecs), values, 1e-12)
    if route == "ops":
        # each gram of the loss entered its plain versions once for all lanes
        assert batched["fwd"] > 0 and batched["bwd"] > 0
        assert plain_calls["fwd"] - batched["fwd"] == R * batched["fwd"] + batched["fwd"]
        assert plain_calls["bwd"] - batched["bwd"] == R * batched["bwd"]


A = torch.tensor([1.0, 3.0, 0.5, 2.0], dtype=torch.float64)
STARTS = torch.tensor([[0.0, 0.0, 0.0, 0.0],  # converges
                       [3.0, -2.0, 1.0, 0.5],
                       [1.0, 1.0, 1.0, 1.0 + 1e-7],  # stops after its first iteration
                       [-0.9, 4.0, -1.0, 2.0],  # its steps reach the NaN region
                       [-1.5, 0.0, 0.0, 0.0]],  # starts where the loss is NaN
                      dtype=torch.float64)


class _Quartic:
    """0.5 Σ a (x - 1)² + 0.25 Σ (x - 1)⁴ a lane, NaN where x₀ < -1, with
    its gradient; records the lanes of every call."""

    def __init__(self):
        self.calls = []

    def __call__(self, vecs):
        self.calls.append(len(vecs))
        d = vecs - 1.0
        values = 0.5 * (A * d * d).sum(-1) + 0.25 * (d ** 4).sum(-1)
        grads = A * d + d ** 3
        bad = vecs[:, 0] < -1.0
        return (torch.where(bad, torch.nan, values),
                torch.where(bad[:, None], torch.nan, grads))


def test_lane_batched_lbfgs_equals_one_lane_runs():
    tol, limit = 1e-6, 20
    fn = _Quartic()
    init, run_range, stats = tfit.lbfgs_lanes(fn, tol)
    vecs, state, its = run_range(STARTS, init(STARTS), np.zeros(len(STARTS)), limit)
    batched_calls = list(fn.calls)
    values, grads = stats(state)
    per_iteration = []
    for r in range(len(STARTS)):
        one = _Quartic()
        init1, run1, stats1 = tfit.lbfgs_lanes(one, tol)
        v, s, it = STARTS[r:r + 1], init1(STARTS[r:r + 1]), np.zeros(1)
        counts = []
        for lim in range(1, limit + 1):  # an iteration at a time, counting its calls
            before = len(one.calls)
            v, s, it = run1(v, s, it, lim)
            counts.append(len(one.calls) - before)
        per_iteration.append(counts)
        assert its[r] == it[0]
        np.testing.assert_allclose(vecs[r].numpy(), v[0].numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(values[r], stats1(s)[0][0], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(grads[r].numpy(), stats1(s)[1][0].numpy(),
                                   rtol=1e-10, atol=1e-10)
    # lanes stopped at different iterations, one on its first, the NaN lane after one
    assert its[2] == 1 and its[4] == 1 and len(set(its.tolist())) >= 3
    assert not np.isfinite(values[4]) and np.isfinite(values[:4]).all()
    # one evaluation a linesearch step for the lanes still searching
    per_iteration = np.array(per_iteration)
    assert len(batched_calls) == per_iteration.max(axis=0).sum()
    assert sum(batched_calls) == per_iteration.sum()
    assert max(batched_calls) == len(STARTS)


def test_lane_states_take_and_put_round_trip():
    fn = _Quartic()
    init, run_range, _ = tfit.lbfgs_lanes(fn, 1e-12)
    _, state, _ = run_range(STARTS[:4], init(STARTS[:4]), np.zeros(4), 3)
    rows = np.array([1, 3])
    part = state.take(rows)
    assert part.S.shape == (2, 30, 4) and part.value.shape == (2,)
    whole = copy.deepcopy(state)
    part.value[:] = 7.0
    part.grad = part.grad + 1.0
    state.put(rows, part)
    assert (state.value[rows] == 7.0).all() and (state.value[[0, 2]] == whole.value[[0, 2]]).all()
    assert torch.equal(state.grad[1], whole.grad[1] + 1.0)
    assert torch.equal(state.grad[0], whole.grad[0])


@pytest.fixture(scope="module")
def gpr():
    return _gpr()


MS = dict(n_starts=3, jitter=0.3, seed=0, include_init=True, warm_adam_steps=5,
          chunk_iters=2)


def test_in_turn_checkpoint_resumes_to_the_batched_result(tmp_path, gpr):
    _, tm, _, tloss = gpr
    whole = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=8, **MS)
    path = tmp_path / "ms.npz"
    path.write_bytes(PARENT_CHECKPOINT.read_bytes())
    resumed = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=8,
                                       checkpoint_path=path, **MS)
    _close(resumed.losses, whole.losses, 1e-9)
    _close(tp.flatten_trainable(resumed.model), tp.flatten_trainable(whole.model), 1e-7)
    # the batched multistart writes the same layout
    ours = tmp_path / "ours.npz"
    tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=4, checkpoint_path=ours,
                             **MS)
    with np.load(PARENT_CHECKPOINT) as theirs, np.load(ours) as mine:
        assert sorted(theirs.files) == sorted(mine.files)
        for k in theirs.files:
            assert (theirs[k].shape, theirs[k].dtype) == (mine[k].shape, mine[k].dtype), k
        _close(mine["0.vec"], theirs["0.vec"], 1e-9)


def test_lane_checkpoint_resumes_bitwise(tmp_path, gpr):
    _, tm, _, tloss = gpr
    path = tmp_path / "ms.npz"
    whole = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=9, **MS)
    tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=5, checkpoint_path=path, **MS)
    resumed = tms.fit_lbfgs_multistart(copy.deepcopy(tm), tloss, max_iters=9,
                                       checkpoint_path=path, **MS)
    assert torch.equal(resumed.losses, whole.losses) and resumed.fun == whole.fun
    assert resumed.num_iters == whole.num_iters


@pytest.mark.parametrize("staggered", [False, True])
def test_vmapped_natgrad_step_equals_the_single_start_step(staggered):
    model, loss_fn = _svgp(False, "gaussian")
    vecs = tms._make_starts(tp.flatten_trainable(model).detach(), R, 0.3, 2, True)
    leaf = vecs.clone().requires_grad_(True)
    step = tng.natgrad_lanes_step(tfit.adam(leaf, 1e-2), leaf, model, loss_fn, 0.2,
                                  staggered=staggered)
    losses = [step() for _ in range(2)]
    for r in range(R):
        one = vecs[r].clone().requires_grad_(True)
        single = tng.natgrad_adam_step(tfit.adam(one, 1e-2), one, model, loss_fn, 0.2,
                                       staggered=staggered)
        for k in range(2):
            _close(losses[k][r], single(), 1e-10)
        _close(leaf[r], one, 1e-10)


@pytest.mark.parametrize("N,M,lanes,want", [(100, 100, 1, 1), (100, 100, 64, 0),
                                            (512, 512, 4, 0), (300, 200, 4, 1)])
def test_pick_tile_counts_every_lanes_blocks(N, M, lanes, want):
    """The tile of a lane-batched launch covers the SMs with the blocks of
    all its lanes: the large tile once lanes × its blocks reach the count."""
    assert og.pick_tile(N, M, [(64, 64), (32, 32)], 132, lanes) == want
