"""The fused gram's host self time per evaluation, in ms: the spans
``oak.gram.fwd`` (``ops/oak_gram.py::oak_gram_fused``: K1's checks, tile and
launch) and ``oak.gram.bwd`` (``FusedGram.backward``: K2's), read from the
program's record of the traced window (``benchmark/spans.py``). Layer:
kernels."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.gram.fwd", "oak.gram.bwd"])
