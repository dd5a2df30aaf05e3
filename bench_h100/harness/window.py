"""The measured window and its arithmetic.

A closed loop with one caller: each step starts when the previous one's
loss is on the host.  The window runs steps until `seconds` have passed;
its last step may run past that, and the window ends where it ends.
Every step counts: frames/s is frames over the whole window, and the
95th percentile is over every step's time, each from the step's start to
its loss on the host.
"""

import os
import statistics
import time
from dataclasses import dataclass


def process_age():
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


@dataclass
class Window:
    start: float          # perf_counter at the first step's start
    end: float            # perf_counter at the last step's end
    step_seconds: list    # each step's time


def run(step, seconds, after_step=None):
    """Runs step(0), step(1), ... until `seconds` have passed; after_step()
    runs after each step, outside the step's time but inside the window."""
    durations = []
    start = time.perf_counter()
    k = 0
    while True:
        begin = time.perf_counter()
        step(k)
        end = time.perf_counter()
        durations.append(end - begin)
        if after_step is not None:
            after_step()
        k += 1
        if end - start >= seconds:
            return Window(start, time.perf_counter(), durations)


def percentile(values, q):
    """The q-th percentile (0 < q < 100, a whole number) of `values`,
    linear between order statistics (statistics.quantiles' inclusive
    method); the only value of a single one."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def frames_per_second(window, batch):
    return batch * len(window.step_seconds) / (window.end - window.start)


def step_ms_p95(window):
    return 1e3 * percentile(window.step_seconds, 95)
