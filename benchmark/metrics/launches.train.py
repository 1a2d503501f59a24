"""Kernel launches per optimiser evaluation: the kernel-launch runtime
calls that torch.profiler saw in the traced window, over the evaluations
(a batched evaluation of all lanes counts once). Layer: the entry and the
optimiser (``models/svgp.py``, ``models/sgpr.py``, ``optim/fit.py``,
``optim/multistart.py``, the autograd op of ``ops/oak_gram.py``)."""


def read(run):
    if run.trace is None or not run.work or run.trace.launches == 0:
        return None
    return run.trace.launches / run.work["units"]
