"""The whole training step's share of the card's FP32 peak, in %: the model
FLOPs of one evaluation, counted from the shapes by ``benchmark/roofline.py``
(the grams forward and backward, the Cholesky, the triangular solves and
the products, and their backward), over the evaluation's time in the
traced run's untraced window (the profiler slows the host) and 67 TFLOP/s
(FP32 outside the tensor cores; TF32 is off)."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.work or run.trace.busy_s <= 0:
        return None
    return roofline.mfu_percent(run.work["unit_flops"], run.work["unit_s"])
