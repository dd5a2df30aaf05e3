"""Profiling and tracing helpers (PyTorch port of
dirt_tpu/utils/profiling.py).

torch.profiler device traces (Chrome trace JSON, viewable in Perfetto or
chrome://tracing), named annotations that show up on the profiler's
timeline and, on the card, as NVTX ranges, and wall-clock section timers
that synchronise the card at section boundaries.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir):
    """Captures a torch.profiler trace of the enclosed computation (host
    activity, and the card's where there is one) and writes it to
    `logdir` as a Chrome trace JSON file.  Yields the profiler.

    Example:
        with profiling.trace('/tmp/dirt_trace'):
            pixels = dirt_tpu_torch.rasterise(...)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name):
    """Named annotation on the profiler's timeline (record_function), and
    an NVTX range where there is a card."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class SectionTimer:
    """Host-side wall-clock section timing (the TIME_SECTIONS analogue).

    Synchronises the card (torch.cuda.synchronize, where there is one) at
    section boundaries, so the numbers cover the card's work.  Usage:

        timer = SectionTimer()
        with timer.section('setup'):
            packed = ...
        with timer.section('render'):
            out = kernel(...)
        print(timer.report())
    """

    def __init__(self):
        self.sections = {}

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - start
            self.sections[name] = self.sections.get(name, 0.0) + elapsed

    def report(self):
        total = sum(self.sections.values())
        lines = [f"{name}: {secs * 1e3:.2f} ms"
                 for name, secs in self.sections.items()]
        lines.append(f"total: {total * 1e3:.2f} ms")
        return "\n".join(lines)
