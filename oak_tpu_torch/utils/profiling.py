"""Timers and traces (``oak_tpu.utils.profiling``): a phase timer that waits
for the device before it stops the clock, named ranges that show in
``torch.profiler`` tables and traces (and in NVTX when the work runs on the
card), and a trace of a whole region for Perfetto or TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range: a ``torch.profiler.record_function`` (in the tables
    and traces of ``torch.profiler``; near free when nothing records), and
    an NVTX range when a card is present (torch built without CUDA has no
    NVTX, so it is not called there)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Trace the region with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write it into ``log_dir`` as a
    ``*.pt.trace.json`` file that Perfetto and TensorBoard read; yields the
    profiler. ``log_dir=None`` traces nothing and yields None."""
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
