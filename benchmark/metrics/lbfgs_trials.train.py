"""Linesearch evaluations per L-BFGS iteration: the program's counters
``lbfgs.trials`` (each evaluation of ``fit.lbfgs_step`` and its
linesearch, the fresh ones included) over ``lbfgs.iters``, read from its
record of the traced window (``benchmark/spans.py``); silent where no
iteration ran. Layer: entry and optimizer."""

from benchmark import spans


def read(run):
    got = spans.record(run)
    if got is None:
        return None
    counters = got[0].counters
    iters = counters.get("lbfgs.iters", 0)
    return counters.get("lbfgs.trials", 0) / iters if iters else None
