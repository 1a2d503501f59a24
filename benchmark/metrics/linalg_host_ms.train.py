"""The linear algebra's host self time per evaluation, in ms: the span
``oak.linalg`` (each public call of ``ops/psd.py``), read from the program's
record of the traced window (``benchmark/spans.py``). Layer: linear
algebra."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.linalg"])
