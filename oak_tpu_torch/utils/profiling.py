"""Timers, spans and counters (``oak_tpu.utils.profiling``): a phase timer
that waits for the device before it stops the clock; the program's spans
(``trace_annotation``) and counters (``count``), recorded in memory and shown
in ``torch.profiler``'s tables and traces; and a trace of a whole region for
Perfetto or TensorBoard.

Spans and counters record at two times: inside ``recording()``, and while a
``torch.profiler`` runs. Otherwise a span is a flag read and a shared no-op
context, and a count a flag read. torch has no cheap way to tell a profiler
that records host activity from one that records the device's alone, so
spans record under either. A recording session starts empty: ``recording()``
opens one; under a profiler the first span or count opens one when none is
open, and it stays open until ``record()`` is read after the profiler has
stopped. ``record()`` returns the last session's spans and counters.

Each span holds its name, its thread, its parent (the innermost span open on
that thread), the evaluation it belongs to (``evaluation``: the latest
evaluation opened anywhere, so that the spans autograd's device thread opens
in a backward take the evaluation whose thread waits for it) and its start
and end on ``time.perf_counter_ns``. A span opened directly inside a span of
the same name is not recorded: the outer one covers it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _torch_profiler

# Spans a session keeps; later ones are counted in ``Record.dropped``.
MAX_SPANS = 1_000_000

_RECORDING = False  # inside recording()
_NULL = contextlib.nullcontext()


def _last_tensor(obj) -> Optional[torch.Tensor]:
    """The last tensor of a tensor, or of a list, tuple or dict of them
    (``oak_tpu`` reads the last leaf of ``block_on``)."""
    from torch.utils._pytree import tree_leaves

    leaves = [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]
    return leaves[-1] if leaves else None


def _wait(block_on) -> None:
    """Wait for the device: ``block_on``'s card, or every card when
    ``block_on`` is None and this process has started CUDA. A CPU tensor's
    work is done when its op returns, so it waits for nothing."""
    if block_on is not None:
        t = _last_tensor(block_on)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
    elif torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class Timer:
    """Phase timer that waits for the device's work before it stops the
    clock. A CUDA op returns when it is queued, so a clock that does not
    wait times the launches, not the work.

        timer = Timer()
        with timer("elbo_step", block_on=losses):
            losses.append(step(...))
        timer.results  # {"elbo_step": 0.123}

    At the end of the block it synchronises the card that holds the last
    tensor of ``block_on`` (a tensor, or a list, tuple or dict of them,
    read when the block ends), or, with ``block_on=None``, every card, if
    this process has started CUDA. Times of one name add up."""

    def __init__(self):
        self.results: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _wait(block_on)
            self.results[name] = self.results.get(name, 0.0) + (time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# Spans and counters
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span: ``parent`` is the index of the innermost span open
    on its thread when it opened (-1 for none), ``eval`` the evaluation it
    belongs to (0 before the session's first), ``end_ns`` None while it is
    open, ``info`` what the opener added (an evaluation's kind and lanes)."""
    name: str
    thread: int
    parent: int
    eval: int
    start_ns: int
    end_ns: Optional[int]
    info: Optional[str] = None


@dataclasses.dataclass
class Record:
    """A session's spans, in the order they opened, its counters and the
    number of spans over ``MAX_SPANS`` that were not kept."""
    spans: List[Span]
    counters: Dict[str, int]
    dropped: int

    def self_ns(self) -> List[int]:
        """Each span's self time: its duration less the union of what its
        children cover. The children of a span are the spans whose parent
        it is; an evaluation's (``oak.eval``) are also the spans of its
        evaluation that opened with no parent on another thread (those of
        its backward on autograd's device thread, while its own thread
        waits). A span still open has 0."""
        children: Dict[int, List[Tuple[int, int]]] = {}
        evals = {s.eval: i for i, s in enumerate(self.spans) if s.name == EVAL}
        for s in self.spans:
            if s.end_ns is None:
                continue
            if s.parent >= 0:
                children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
            elif s.eval in evals and s.thread != self.spans[evals[s.eval]].thread:
                children.setdefault(evals[s.eval], []).append((s.start_ns, s.end_ns))
        out = []
        for i, s in enumerate(self.spans):
            if s.end_ns is None:
                out.append(0)
                continue
            covered = _covered(children.get(i, ()), s.start_ns, s.end_ns)
            out.append(s.end_ns - s.start_ns - covered)
        return out

    def self_ms(self, names: Sequence[str]) -> float:
        """The summed self time of the spans named ``names``, in ms."""
        return 1e-6 * sum(t for s, t in zip(self.spans, self.self_ns()) if s.name in names)


def _covered(intervals, start: int, end: int) -> int:
    """The length of the union of ``intervals`` inside [start, end]."""
    total, reach = 0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            total += b - a
            reach = b
    return total


EVAL = "oak.eval"


class _Session:
    def __init__(self, profiled: bool):
        self.profiled = profiled  # opened under a profiler, still open
        self.spans: List[list] = []  # [name, thread, parent, eval, start, end, info]
        self.counters: Dict[str, int] = {}
        self.stacks: Dict[int, List[int]] = {}  # each thread's open spans
        self.evals = 0
        self.dropped = 0


_session = _Session(profiled=False)
_lock = threading.Lock()


def _current() -> _Session:
    """The session a span or count goes to: ``recording()``'s, or the one a
    profiler opened, a new one if none is open."""
    global _session
    if not _RECORDING and not _session.profiled:
        with _lock:
            if not _session.profiled:
                _session = _Session(profiled=True)
    return _session


class _Span:
    __slots__ = ("name", "info", "kind", "lanes", "session", "index", "rf")

    def __init__(self, name: str, info: Optional[str] = None, kind: str = "", lanes: int = 0):
        self.name, self.info, self.kind, self.lanes = name, info, kind, lanes
        self.index = None

    def __enter__(self):
        if torch.compiler.is_compiling():
            return self  # tracing for export or compile: record nothing
        s = self.session = _current()
        stack = s.stacks.setdefault(threading.get_ident(), [])
        if stack and s.spans[stack[-1]][0] == self.name:
            return self
        if self.kind:
            s.evals += 1
            _add(s, f"evals.{self.kind}", 1)
            _add(s, f"lanes.{self.kind}", self.lanes)
        row = [self.name, threading.get_ident(), stack[-1] if stack else -1, s.evals, 0, None,
               self.info]
        with _lock:  # autograd's device thread opens spans too
            if len(s.spans) >= MAX_SPANS:
                s.dropped += 1
                return self
            self.index = len(s.spans)
            s.spans.append(row)
        stack.append(self.index)
        self.rf = None
        if _torch_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name, self.info)
            self.rf.__enter__()
        row[4] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index is None:
            return False
        s = self.session
        s.spans[self.index][5] = time.perf_counter_ns()
        stack = s.stacks[threading.get_ident()]
        # a span left open by an exception closes with the one around it
        while stack and stack.pop() != self.index:
            pass
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def trace_annotation(name: str):
    """The program's span: a context manager. While nothing records it is
    one flag read and a shared no-op context. While a session records (see
    the module's docstring) it appends a ``Span`` to the session and, under
    a ``torch.profiler``, opens a ``record_function`` range of the same name,
    which lands in the profiler's tables, traces and device timeline on the
    profiler's clock."""
    if _RECORDING or _torch_profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


def evaluation(kind: str, lanes: int):
    """The span ``oak.eval`` of one evaluation of the loss over ``lanes``
    lanes (``kind`` "grad" or "value"): it opens a new evaluation id and
    counts ``evals.<kind>`` and ``lanes.<kind>``. Inside another
    evaluation it records and counts nothing."""
    if _RECORDING or _torch_profiler._is_profiler_enabled:
        return _Span(EVAL, f"{kind} {lanes}", kind, lanes)
    return _NULL


def spanned(name: str) -> Callable:
    """Decorator: every call of the function runs inside
    ``trace_annotation(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _RECORDING or _torch_profiler._is_profiler_enabled:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return inner

    return wrap


def span_steps(optimizer: torch.optim.Optimizer, name: str) -> torch.optim.Optimizer:
    """Each ``optimizer.step()`` inside the span ``name``, through the
    optimizer's step hooks (callers that step it themselves are spanned
    too); returns the optimizer."""
    open_spans: List[_Span] = []

    def pre(opt, args, kwargs):
        if _RECORDING or _torch_profiler._is_profiler_enabled:
            span = _Span(name)
            span.__enter__()
            open_spans.append(span)

    def post(opt, args, kwargs):
        if open_spans:
            open_spans.pop().__exit__(None, None, None)

    optimizer.register_step_pre_hook(pre)
    optimizer.register_step_post_hook(post)
    return optimizer


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the session that records; nothing
    while none does."""
    if _RECORDING or _torch_profiler._is_profiler_enabled:
        _add(_current(), name, n)


def _add(s: _Session, name: str, n: int) -> None:
    with _lock:
        s.counters[name] = s.counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record the spans and counters of the region in a new session, with
    or without a profiler; read them with ``record()``."""
    global _RECORDING, _session
    with _lock:
        _session = _Session(profiled=False)
    outer, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = outer


def record() -> Record:
    """The last session's spans and counters. A session a profiler opened
    ends here if the profiler has stopped, so that the next one starts
    empty."""
    s = _session
    if s.profiled and not _torch_profiler._is_profiler_enabled:
        s.profiled = False
    return Record(spans=[Span(*row) for row in s.spans], counters=dict(s.counters),
                  dropped=s.dropped)


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Trace the region with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write it into ``log_dir`` as a
    ``*.pt.trace.json`` file that Perfetto and TensorBoard read; yields the
    profiler. ``log_dir=None`` traces nothing and yields None. The
    program's spans show in the trace by name."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
