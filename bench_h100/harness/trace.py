"""The device trace of a steady run of steps, and what it says.

Two profiles follow the window, each over a few steps.  The first records
the device's activity alone: the profiler's host-side recording would
lengthen every step several times and inflate the idle share, so its
window is the host's wall time of its steps (every device operation of
those steps lies inside it: the device starts no work before the first
launch, and the last step ends when its loss is on the host).  It gives
the busy and idle shares, the launches and each kernel's time.  The
second also records the host's operations and the benchmark's spans
(program.Program.step's scene, rasterise, shader, loss, backward and
readback, each step inside a "step" span): its Chrome trace holds, for
every device operation, the correlation id of the host call that
launched it, and the launch's host time places the operation in the
innermost span then open.  Kernels launched by the autograd engine's
thread are placed by time alike: the caller's thread sits in its
"backward" span until the engine is done.  It gives each span's device
time and names the idle gaps by the span the host was in (gaps that its
own recording lengthens).
"""

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass

import torch

PROFILE_TRIES = 3    # a profile now and then records no device event
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
STEP = "step"
OUTSIDE = "between spans"


@dataclass
class DeviceOp:
    name: str
    start: float    # microseconds on the trace's clock
    end: float
    span: str       # innermost span open at its launch; None if unknown


def _union(intervals):
    """The union of (start, end) intervals, as sorted disjoint [start,
    end] pairs; empty intervals are left out."""
    merged = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(spans, starts, t):
    """The name of the innermost span of `spans` (sorted by start, outer
    spans first where starts tie; `starts` their starts) open at time t,
    else None: the one that started last of those that hold t."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        start, end, name = spans[i]
        if start <= t <= end:
            return name
    return None


class Trace:
    """The device operations of `steps` traced steps, placed in spans
    where the host's activity was recorded, and the traced window: the
    steps' host wall time (`window_s`) from the first operation, else from
    the first step span's start to the last one's end."""

    def __init__(self, events, steps, window_s=None):
        # By start, the outer of two spans that start together first.
        spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("ph") == "X"),
                       key=lambda s: (s[0], -s[1]))
        starts = [s[0] for s in spans]
        launches = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in LAUNCH_CATEGORIES
                    and "correlation" in e.get("args", {})}
        self.steps = steps
        self.spans = spans
        self.starts = starts
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATEGORIES or e.get("ph") != "X":
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            span = None if launch is None else _innermost(spans, starts,
                                                          launch)
            self.ops.append(DeviceOp(e["name"], e["ts"], e["ts"] + e["dur"],
                                     span))
        self.ops.sort(key=lambda op: op.start)
        step_spans = [s for s in spans if s[2] == STEP]
        if window_s is not None:
            # The host's wall time of the steps, from the first operation.
            first = self.ops[0].start if self.ops else 0.0
            self.window = (first, first + window_s * 1e6)
        elif step_spans:
            self.window = (step_spans[0][0], max(s[1] for s in step_spans))
        else:
            self.window = (0.0, 0.0)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        return _union((max(op.start, lo), min(op.end, hi))
                      for op in self.ops)

    @property
    def busy_s(self):
        return sum(end - start for start, end in self.busy_intervals()) * 1e-6

    def idle_gaps(self):
        """The window's idle gaps, each (seconds, the span the host was in
        at its middle: the innermost one, OUTSIDE where only the step's)."""
        gaps, t = [], self.window[0]
        for start, end in self.busy_intervals() + [[self.window[1]] * 2]:
            if start > t:
                name = _innermost(self.spans, self.starts, (t + start) / 2)
                gaps.append(((start - t) * 1e-6,
                             OUTSIDE if name in (None, STEP) else name))
            t = max(t, end)
        return gaps

    def unplaced_share(self):
        """The share of the device time whose launch no span holds."""
        total = sum(op.end - op.start for op in self.ops)
        lost = sum(op.end - op.start for op in self.ops if op.span is None)
        return lost / total if total else 1.0

    def span_ms(self, span):
        """Device ms a step of the operations launched in `span`."""
        return sum(op.end - op.start for op in self.ops
                   if op.span == span) * 1e-3 / self.steps

    def kernel_ms(self, name):
        """Device ms a step of the kernels whose name holds `name`."""
        return sum(op.end - op.start for op in self.ops
                   if name in op.name) * 1e-3 / self.steps



def breakdown(device_trace, span_trace, top=10):
    """The device operations that took most time (from the device-only
    trace) and the idle gaps by the host's span (from the trace with the
    host's activity), seconds over each traced window."""
    ops, gaps = {}, {}
    for op in device_trace.ops:
        ops[op.name[:96]] = ops.get(op.name[:96], 0.0) + (
            op.end - op.start) * 1e-6
    for seconds, name in span_trace.idle_gaps():
        gaps[name] = gaps.get(name, 0.0) + seconds
    largest = lambda d: [[k, v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(ops), "idle_gaps": largest(gaps)}


def chrome_events(prof):
    """The profile's Chrome trace events, through a file under TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def profile_steps(step, first, steps, host):
    """Runs step(first), step(first + 1), ... `steps` at a time under
    torch.profiler, each in a STEP span, recording the device's activity
    and, with `host`, the host's; again on the next steps while the trace
    holds no device operation, PROFILE_TRIES times at most.  Without
    `host` the window is the steps' wall time on the host.  Returns
    (Trace, the indices of the traced steps)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    k = first
    for _ in range(PROFILE_TRIES):
        ks = list(range(k, k + steps))
        with profile(activities=activities) as prof:
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in ks:
                with torch.profiler.record_function(STEP):
                    step(i)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        trace = Trace(chrome_events(prof), steps,
                      None if host else seconds)
        if trace.ops:
            return trace, ks
        k += steps
    raise RuntimeError(f"the profiler recorded no device operation in "
                       f"{PROFILE_TRIES} tries")
