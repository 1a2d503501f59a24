"""Launches of the training bounds' triangular-solve kernel per evaluation:
the program's counter ``solve.launches`` (one a solve, A = L⁻¹Kuf or, in
the backward, dKuf = L⁻ᵀdA, counted in ``oak_tpu_torch/ops/tri_solve.py``),
read from its record of the traced window (``benchmark/spans.py``). Silent
for a program without that kernel. Layer: linear algebra."""

import importlib.util

from benchmark import spans


def read(run):
    if importlib.util.find_spec("oak_tpu_torch.ops.tri_solve") is None:
        return None
    return spans.per_eval(run, "solve.launches")
