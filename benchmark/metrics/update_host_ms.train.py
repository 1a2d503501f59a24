"""The optimiser's host self time per evaluation, in ms: the spans
``oak.update`` (Adam's step, ``finite_or_zero``, the best iterate's
tracking, L-BFGS's direction and update) and ``oak.linesearch`` (the host
linesearch's arithmetic between evaluations), read from the program's record
of the traced window (``benchmark/spans.py``). Layer: entry and
optimizer."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.update", "oak.linesearch"])
