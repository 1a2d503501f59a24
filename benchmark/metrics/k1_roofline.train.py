"""K1's share of its roofline in a training step, in %: the frozen bound of
the work of every K1 launch of the traced window at the cell's shapes
(``benchmark/roofline.py``), over K1's device time there, taken by kernel
name (the one-lane and the lanes builds alike). Silent when the launches
seen differ in number from those the generator accounted for. Layer: kernels
(``csrc/oak_gram_fwd*.cu``)."""

KERNEL = "oak_gram_fwd_kernel"


def read(run):
    if run.trace is None or not run.work:
        return None
    n, seconds = run.trace.time_of(KERNEL)
    if n == 0 or n != len(run.work["K1"]) or seconds <= 0:
        return None
    return 100.0 * sum(w.bound_s() for w in run.work["K1"]) / seconds
