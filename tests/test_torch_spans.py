"""The program's spans and counters (``oak_tpu_torch.utils.profiling``), on
the CPU at float64 and small sizes:

- with nothing recording, an SVGP Adam step and a 4-lane vmapped
  ``LaneLoss`` evaluation leave the record empty and never enter
  ``record_function``;
- losses and gradients are bitwise equal recorded and not, for one lane and
  for 4 vmapped lanes;
- under a CPU ``torch.profiler`` one Adam step, its grams through the card's
  route (``og._prep``, ``og.fused_op``), records each span of the step with
  its parent and the step's one evaluation, a self time between 0 and its
  duration, and its name among the profiler's events;
- a 2-lane ``fit_lbfgs_multistart`` counts the loss's own gradient
  evaluations, at least one linesearch trial an iteration, every host read's
  site and the linesearch's host spans;
- at each launch site (the card's calls stubbed), ``LAUNCHES``,
  ``BWD_LAUNCHES`` and the Triton op's ``LAUNCHES`` move with the counters
  ``k1.launches``, ``k2.launches`` and ``k1_triton.launches``;
- the record's sessions, self time across threads, the cap, the decorator
  and the optimizer's step hooks; an export while recording stays free of
  spans.
"""

import threading

import numpy as np
import pytest
import torch

from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SGPR, SVGP, Gaussian
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.optim import fit as tfit
from oak_tpu_torch.optim import multistart as tms
from oak_tpu_torch.utils import profiling

KW = dict(dtype=torch.float64, device="cpu")
DEPTH = 3
STEP_SPANS = {"oak.eval", "oak.bound", "oak.prep", "oak.gram.fwd", "oak.gram.bwd",
              "oak.linalg", "oak.update"}


def _data(n=24, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y[:, None]


def _kernel(d=3):
    return OAKKernel.create(num_dims=d, max_interaction_depth=DEPTH, **KW)


def _svgp():
    X, Y = _data()
    m = SVGP.create(_kernel(), Gaussian.create(0.1, **KW), X[:8], num_data=len(X), **KW)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    return m, lambda mm: mm.training_loss(Xt, Yt)


def _sgpr():
    X, Y = _data()
    return (SGPR.create(X, Y, _kernel(), X[:8], noise_variance=0.1, **KW),
            lambda m: m.training_loss())


def _k_card_route(self, X, X2=None):
    """OAKKernel.K through the card's route (``og._prep`` and ``og.fused_op``:
    FusedGram or the registered op) on CPU tensors."""
    return og.fused_op(og._prep(self, X, X if X2 is None else X2), self.max_interaction_depth)


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(OAKKernel, "K", _k_card_route)


def _adam_step(model, loss_fn):
    vec = tfit._leaf(model)
    opt = tfit.adam(vec)
    return tfit._adam_step(model, loss_fn, vec, opt), vec


def _lanes(model, loss_fn, R=4):
    vec0 = tp.flatten_trainable(model).detach()
    return tfit.LaneLoss(model, loss_fn), tms._make_starts(vec0, R, 0.3, 1, True)


def test_nothing_records_and_record_function_is_never_entered_when_off(monkeypatch,
                                                                       card_route):
    with profiling.recording():
        pass  # a new, empty session

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with nothing recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _adam_step(*_svgp())
    lanes, vecs = _lanes(*_svgp())
    lanes.value_and_grad(vecs)
    rec = profiling.record()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


@pytest.mark.parametrize("R", [1, 4])
def test_losses_and_gradients_are_bitwise_equal_recorded_or_not(card_route, R):
    lanes, vecs = _lanes(*_svgp(), R=R)
    off = lanes.value_and_grad(vecs)
    with profiling.recording():
        on = lanes.value_and_grad(vecs)
    assert profiling.record().counters["evals.grad"] == 1
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_an_adam_step_records_every_span_under_the_profiler(card_route):
    from torch.profiler import ProfilerActivity, profile

    profiling.record()  # ends a session an earlier profiler left open
    model, loss_fn = _svgp()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _adam_step(model, loss_fn)
    rec = profiling.record()
    names = {s.name for s in rec.spans}
    assert names == STEP_SPANS
    assert rec.counters["evals.grad"] == 1 and rec.counters["lanes.grad"] == 1
    by_index = dict(enumerate(rec.spans))
    parents = {s.name: by_index[s.parent].name if s.parent >= 0 else None
               for s in rec.spans}
    assert parents["oak.eval"] is None and parents["oak.update"] is None
    assert parents["oak.bound"] == "oak.eval"
    assert parents["oak.prep"] == parents["oak.gram.fwd"] == "oak.bound"
    # autograd runs a CPU backward on the evaluation's own thread
    assert parents["oak.gram.bwd"] == "oak.eval"
    for s, own in zip(rec.spans, rec.self_ns()):
        assert s.eval == 1 and s.end_ns is not None
        assert 0 <= own <= s.end_ns - s.start_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert sum(s.name == "oak.eval" for s in rec.spans) == 1
    assert STEP_SPANS <= {e.name for e in prof.events()}


def test_each_linalg_call_is_one_span_however_they_nest():
    from oak_tpu_torch.ops import psd

    A = torch.eye(4, **KW) * 2.0
    with profiling.recording():
        L = psd.cholesky(A)
        psd.cholesky_solve(L, A)
        psd.chol_of_inv(A)
    assert [s.name for s in profiling.record().spans] == ["oak.linalg"] * 3


class _CountingLoss:
    """The loss, counting its evaluations with a gradient."""

    def __init__(self, loss_fn):
        self.loss_fn, self.grads = loss_fn, 0

    def __call__(self, m):
        self.grads += torch.is_grad_enabled()
        return self.loss_fn(m)


def test_a_multistart_counts_evaluations_trials_and_host_reads():
    model, loss_fn = _sgpr()
    loss = _CountingLoss(loss_fn)
    with profiling.recording():
        res = tms.fit_lbfgs_multistart(model, loss, n_starts=2, jitter=0.1, seed=3,
                                       max_iters=4)
    assert np.isfinite(res.fun)
    rec = profiling.record()
    c = rec.counters
    assert c["evals.grad"] == loss.grads > 0
    assert c["lbfgs.iters"] >= 1 and c["lbfgs.trials"] >= c["lbfgs.iters"]
    # the starts, each iteration's slope, each trial (the fresh one
    # included), each lane's finiteness and its final losses
    assert c["host_reads"] == 1 + c["lbfgs.iters"] + c["lbfgs.trials"] + 2
    names = {s.name for s in rec.spans}
    assert {"oak.eval", "oak.linesearch", "oak.update", "oak.bound", "oak.linalg"} <= names
    assert {s.parent for s in rec.spans if s.name == "oak.linesearch"} == {-1}


class _Library:
    """The CUDA library's entry points, launching nothing."""

    def oak_gram_fwd_f32(self, *args):
        return 0

    def oak_gram_bwd_f32(self, *args):
        return 0

    def oak_gram_bwd_workspace(self, *args):
        return 1


def test_launch_globals_and_counters_agree_at_each_launch_site(monkeypatch):
    """``_launch_fwd``, ``_launch_bwd`` and the Triton op's launch, run on
    CPU tensors with the card's calls stubbed: each launch moves its global
    and its counter by one. On the card a whole step does
    (``test_torch_gpu.py::test_launch_counters_agree_over_a_step``)."""
    import contextlib

    from oak_tpu_torch.ops import oak_gram_triton as ogt
    from oak_tpu_torch.testing import prescaled_inputs

    monkeypatch.setattr(og, "_check_cuda_inputs", lambda inputs, *a, **k: [0] * len(inputs))
    monkeypatch.setattr(og, "_variant", lambda *a, **k: 0)
    monkeypatch.setattr(og, "_stream", lambda t: 0)
    monkeypatch.setattr(og._build, "library", lambda: _Library())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ogt, "_launch", lambda inputs, depth, traced: inputs[0])
    args = prescaled_inputs(5, 3, 6, 5, 0, DEPTH, "cpu")
    gbar = torch.ones(6, 5)
    before = og.LAUNCHES, og.BWD_LAUNCHES, ogt.LAUNCHES
    with profiling.recording():
        for _ in range(2):
            og._launch_fwd(args, DEPTH)
        og._launch_bwd((*args, gbar), DEPTH, with_dextra=False)
        ogt._cuda(*args, DEPTH)
    c = profiling.record().counters
    assert c == {"k1.launches": 2, "k2.launches": 1, "k1_triton.launches": 1}
    assert (og.LAUNCHES - before[0], og.BWD_LAUNCHES - before[1],
            ogt.LAUNCHES - before[2]) == (2, 1, 1)


def test_sessions_start_empty_and_counts_stop_outside_them():
    profiling.count("outside")
    with profiling.recording():
        profiling.count("a", 2)
        with profiling.trace_annotation("x"):
            pass
    profiling.count("a")
    assert profiling.record().counters == {"a": 2}
    with profiling.recording():
        pass
    assert profiling.record().spans == []


def test_a_profiler_opens_a_session_that_ends_when_read_after_it_stops():
    from torch.profiler import ProfilerActivity, profile

    profiling.record()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.trace_annotation("y"):
                pass
        assert [s.name for s in profiling.record().spans] == ["y"]


def test_self_time_takes_off_children_and_an_evaluations_other_thread():
    spans = [profiling.Span("oak.eval", 1, -1, 1, 0, 100),
             profiling.Span("oak.bound", 1, 0, 1, 10, 40),
             profiling.Span("oak.linalg", 1, 1, 1, 20, 30),
             profiling.Span("oak.gram.bwd", 2, -1, 1, 50, 70),
             profiling.Span("oak.update", 1, -1, 1, 100, 110),
             profiling.Span("oak.update", 1, -1, 1, 120, None)]
    rec = profiling.Record(spans, {}, 0)
    assert rec.self_ns() == [50, 20, 10, 20, 10, 0]
    assert rec.self_ms(["oak.eval", "oak.gram.bwd"]) == 70e-6


def test_a_span_on_another_thread_takes_the_latest_evaluation():
    with profiling.recording():
        with profiling.evaluation("grad", 2):
            t = threading.Thread(target=lambda: profiling.trace_annotation("oak.gram.bwd")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.evaluation("grad", 2):
                pass  # nested: neither recorded nor counted
    rec = profiling.record()
    assert [(s.name, s.parent, s.eval) for s in rec.spans] == [
        ("oak.eval", -1, 1), ("oak.gram.bwd", -1, 1)]
    assert rec.spans[0].thread != rec.spans[1].thread
    assert rec.counters == {"evals.grad": 1, "lanes.grad": 2}


def test_spans_over_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.trace_annotation("z"):
                pass
    rec = profiling.record()
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_decorated_functions_and_optimizer_steps_are_spans():
    @profiling.spanned("oak.deco")
    def f(x, y=1):
        return x + y

    vec = torch.zeros(3, requires_grad=True)
    opt = tfit.adam(vec)
    vec.grad = torch.ones(3)
    with profiling.recording():
        assert f(1, y=2) == 3
        opt.step()
    assert [s.name for s in profiling.record().spans] == ["oak.deco", "oak.update"]
    assert f.__name__ == "f"


def test_an_export_while_recording_has_no_span_in_its_graph():
    class Gram(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.k = _kernel()

        def forward(self, X):
            return og.oak_gram_fused(*og._prep(self.k, X, X), DEPTH)

    X = torch.as_tensor(_data()[0])
    with profiling.recording():
        ep = torch.export.export(Gram(), (X,))
    assert "profiler" not in str(ep.graph)
    assert profiling.record().spans == []
