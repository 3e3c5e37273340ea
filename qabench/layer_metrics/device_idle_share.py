"""Device: the share of the traced window, in %, in which no operation
ran on the card (the profiler's timeline, kernels, copies and fills)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
