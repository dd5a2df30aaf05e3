"""frames_per_s.host_exposed: frames_per_s in a cell whose step the
host's dispatch holds (batch x steps / window, host clock); per layer,
since the host's speed there spreads its runs past any bound."""

from bench_h100.harness import window


def read(readings):
    return window.frames_per_second(readings.window, readings.batch)
