"""The device's idle share of the traced training window, in %: one less
the union of the device operations' intervals over the window."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
