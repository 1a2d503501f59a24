"""The prescale's host self time per evaluation, in ms: the span
``oak.prep`` (``ops/oak_gram.py::_prep``), read from the program's record
of the traced window (``benchmark/spans.py``). Layer: kernels."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.prep"])
