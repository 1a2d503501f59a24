"""K2's share of its roofline in a training step, in %: the frozen bound of
the work of every K2 launch of the traced window at the cell's shapes
(``benchmark/roofline.py``), over K2's device time there: its main kernel
and its reduction, by kernel name, one-lane and lanes builds alike. Silent
when the launches seen differ in number from those the generator accounted
for. Layer: kernels (``csrc/oak_gram_bwd*.cu``)."""

KERNEL, PREFIX = "oak_gram_bwd_kernel", "oak_gram_bwd"


def read(run):
    if run.trace is None or not run.work:
        return None
    n, _ = run.trace.time_of(KERNEL)
    _, seconds = run.trace.time_of(PREFIX)
    if n == 0 or n != len(run.work["K2"]) or seconds <= 0:
        return None
    return 100.0 * sum(w.bound_s() for w in run.work["K2"]) / seconds
