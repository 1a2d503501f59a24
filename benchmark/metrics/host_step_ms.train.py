"""The time of one optimiser evaluation on the host clock, in ms: the
traced run's untraced window (the profiler slows the host) over its
evaluations (a batched evaluation of all lanes counts once). A whole-window
figure, like the end-to-end metrics; it stands here and not among them
because on a shared host it spreads too widely from run to run to hold a
bound. Layer: the whole step."""


def read(run):
    if not run.work or run.work.get("unit_s", 0) <= 0:
        return None
    return 1e3 * run.work["unit_s"]
