"""The program's own spans and counters (``oak_tpu_torch.utils.profiling``),
which record while the traced window's profiler runs, read for the
per-layer metrics of ``metrics/``: each divides by the program's own count
of loss-and-gradient evaluations, ``evals.grad``.

Silent (None) where the program records nothing (a program without spans),
and where ``evals.grad`` differs from the evaluations the generator
accounted for in the window (``run.work["units"]``). The times are host
self times taken under the profiler, which slows the host about twice:
they rank the layers, and ``host_step_ms.train`` stays the untraced
total."""

from __future__ import annotations

from typing import Optional, Sequence


def record(run):
    """(the program's record of the traced window, its ``evals.grad``), or
    None."""
    try:
        from oak_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    if read is None or not run.work:
        return None
    rec = read()
    if not rec.spans:
        return None
    evals = rec.counters.get("evals.grad", 0)
    if evals <= 0 or evals != run.work["units"]:
        return None
    return rec, evals


def self_ms(run, names: Sequence[str]) -> Optional[float]:
    """The summed host self time of the spans ``names`` per evaluation, in
    ms (0 where none of them ran)."""
    got = record(run)
    if got is None:
        return None
    rec, evals = got
    return rec.self_ms(names) / evals


def per_eval(run, counter: str) -> Optional[float]:
    """The counter ``counter`` per evaluation (0 where it never counted)."""
    got = record(run)
    if got is None:
        return None
    rec, evals = got
    return rec.counters.get(counter, 0) / evals
