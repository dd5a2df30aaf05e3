"""frames_per_s: frames rendered and differentiated in the window over
the window's seconds (batch x steps / window), host clock."""

from bench_h100.harness import window


def read(readings):
    return window.frames_per_second(readings.window, readings.batch)
