"""A window under torch.profiler. ``busy``: the device's busy time over a
whole measured window, read from the device's activity alone (the
end-to-end ``train_device_ms``). ``traced``: one traced window reduced to
what the per-layer readers need: the device operations with their
intervals, the kernel-launch runtime calls, the window on the profiler's
clock, the device's busy time (the union of the operations' intervals, so
that overlapping streams count once), and the breakdown that the result
line carries."""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import torch

WINDOW = "bench.window"
# The CUDA calls (runtime cuda*, low-level cu*) that launch a kernel.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


T = TypeVar("T")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # (name, start s, end s) inside the window
    launches: int
    device_ops: List[List]  # [[name, seconds]], the 10 that took most time
    idle_gaps: List[List]  # [[host op, seconds]], idle time by what the host ran

    def time_of(self, pattern: str) -> Tuple[int, float]:
        """(count, total seconds) of the device operations whose name holds
        ``pattern``."""
        hits = [end - start for name, start, end in self.ops if pattern in name]
        return len(hits), sum(hits)


def traced(fn: Callable[[], None]) -> Optional[DeviceTrace]:
    """The trace of ``fn``, run inside the profiler and a span named
    ``WINDOW``; the device is synchronised before the span ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return reduce(prof.events())


def busy(fn: Callable[[], T]) -> Tuple[T, Optional[float]]:
    """``fn()`` under torch.profiler with the device's activity alone (the
    host's operations are not recorded, so the host slows little), and the
    device's busy seconds in it: the union of the intervals of every device
    operation (kernels, copies, sets) that ``fn`` and the synchronisation
    after it waited for. None without a CUDA card or where the profiler saw
    no device operation."""
    if not torch.cuda.is_available():
        return fn(), None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    # the raw events: building torch's FunctionEvents for some 10^5
    # launches would take longer than the window
    intervals = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if not intervals:
        return out, None
    return out, busy_seconds(intervals, 1e-9)


def busy_seconds(intervals: List[Tuple[float, float]], scale: float) -> float:
    """The length of the union of ``intervals``, times ``scale``."""
    return sum(b - a for a, b in _union(intervals)) * scale


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce(events) -> Optional[DeviceTrace]:
    """The trace of the ``WINDOW`` span in ``events`` (torch.profiler's
    FunctionEvents, times in microseconds); None without that span."""
    from torch.autograd import DeviceType

    spans = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not spans:
        return None
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    # a span (record_function) shows on the device's timeline too: it is no
    # device operation
    spans_named = {e.name for e in events if e.device_type == DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)} | {WINDOW}
    ops, host, launches = [], [], 0
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in spans_named:
                continue
            if end > w0 and start < w1:
                ops.append((e.name, max(start, w0), min(end, w1)))
        elif e.name != WINDOW and w0 <= start <= w1:
            host.append((start, end, e.name))
            if e.name.startswith(LAUNCH_CALLS):
                launches += 1
    busy = _union([(a, b) for _, a, b in ops])
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in ops:
        by_name[name] += b - a
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        ops=[(name, a / 1e6, b / 1e6) for name, a, b in ops],
        launches=launches,
        device_ops=[[name, t / 1e6] for name, t in top_ops],
        idle_gaps=_idle_by_host_op(busy, host, w0, w1),
    )


def _idle_by_host_op(busy, host, w0: float, w1: float) -> List[List]:
    """The device's idle time in the window, each gap given to the innermost
    host operation running at its middle (the latest-started one that
    contains it; where none does, Python or numpy work between torch's
    operations), summed by that operation's name: the 10 largest."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host code outside torch ops"
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += b - a
    return [[name, t / 1e6] for name, t in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
