"""device.idle_pct: the share of the traced window (first traced step's
start to the last one's end) in which no device operation runs: one less
the union of their intervals over the window, in %."""


def read(readings):
    trace = readings.trace
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
