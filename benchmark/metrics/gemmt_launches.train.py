"""Launches of the training bounds' lower-triangle product kernel per
evaluation: the program's counter ``gemmt.launches`` (one a product, all
lanes at once: the SGPR bound's AAᵀ and the wide solve's backward
dL = −tril(dB Xᵀ), counted in ``oak_tpu_torch/ops/gemmt.py``), read from
its record of the traced window (``benchmark/spans.py``). Silent where the
record holds no such counter: a program whose bounds leave these products to
the library. Layer: linear algebra."""

from benchmark import spans

COUNTER = "gemmt.launches"


def read(run):
    got = spans.record(run)
    if got is None or COUNTER not in got[0].counters:
        return None
    return spans.per_eval(run, COUNTER)
