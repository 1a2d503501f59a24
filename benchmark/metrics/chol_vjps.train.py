"""The Cholesky's reverse passes of the program's own per evaluation: the
counter ``chol.vjp`` (one a reverse pass, whose two triangular solves run
on the solve kernel, counted in ``oak_tpu_torch/ops/psd.py``), read from its
record of the traced window (``benchmark/spans.py``). Silent where the
record holds no such counter: a program whose Cholesky keeps autograd's
backward. Layer: linear algebra."""

from benchmark import spans

COUNTER = "chol.vjp"


def read(run):
    got = spans.record(run)
    if got is None or COUNTER not in got[0].counters:
        return None
    return spans.per_eval(run, COUNTER)
