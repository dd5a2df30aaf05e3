"""step_ms_p95: the 95th percentile of every step's time in the window,
from the step's start to its loss on the host, host clock."""

from bench_h100.harness import window


def read(readings):
    return window.step_ms_p95(readings.window)
