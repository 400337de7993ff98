"""The share of the traced window in which the card ran nothing: no
kernel, copy or set in the profiler's device activity."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s() / r.window_s)
