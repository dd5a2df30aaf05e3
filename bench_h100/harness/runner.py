"""One run of one cell: set-up, the window, the trace, the check.

Set-up makes the inputs on the device from the seed, builds the step
(the port's kernel library loads, and builds in a fresh checkout, at its
first call) and warms it on every pool entry once, so the window sees
only shapes and kernels already built.  The window then runs for
`seconds`; a traced run times the benchmark's spans there, and goes on
with a few profiled steps, the spans recorded in the profile of the
host.  Then the program's state is freed and the reference recomputes
the kept steps.
"""

import gc
import math
from dataclasses import dataclass, field

import torch

from ..reference import forward, scene
from . import check, inputs as cell_inputs, spec, window as timing
from .program import Program, Spans
from .trace import profile_steps


@dataclass
class Readings:
    """What the metric readers read: one run's window and, in a traced
    run, its trace."""
    cell: spec.Cell
    batch: int
    height: int
    width: int
    channels: int                        # the rasterised buffer's
    window: timing.Window = None
    setup_s: float = None
    peak_bytes: int = None
    num_faces: int = 0
    trace: object = None        # trace.Trace, the device's activity alone
    span_trace: object = None   # trace.Trace with the host's and the spans
    traced_coverage: list = field(default_factory=list)  # (fragments,
    # covered pixels) of each step of `trace`, by the reference
    host_seconds: dict = None   # Spans.seconds over a traced run's window
    host_steps: int = 0


@dataclass
class Result:
    readings: Readings
    steps: int
    failed: int
    numbers: dict
    correct: bool
    device: dict = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def measure(cell, seed, seconds, trace, device, setup_start):
    """Runs the cell once on `device`; `setup_start` is the process's start
    on time.perf_counter's clock."""
    traffic, config = cell.traffic, cell.config
    batch = config["batch"]
    data = cell_inputs.make_inputs(cell, seed, device)
    kept = cell_inputs.kept_samples(seed, traffic, batch)
    spans = Spans()
    program = Program(cell, data, kept, spans)
    for k in range(traffic["pool"]):
        program.step(k)
        program.keep()
    program.outputs.clear()
    _sync(device)
    gc.collect()
    gc.freeze()
    setup_peak = _peak(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    losses = []
    step = lambda k: losses.append(program.step(k))
    spans.counting = bool(trace)
    window = timing.run(step, seconds, program.keep)
    spans.counting = False
    readings = Readings(cell=cell, batch=batch, height=config["height"],
                        width=config["width"],
                        channels=data.background.shape[-1],
                        num_faces=data.faces.shape[1], window=window,
                        setup_s=window.start - setup_start,
                        peak_bytes=_peak(device),
                        host_seconds=dict(spans.seconds),
                        host_steps=len(window.step_seconds))
    gc.unfreeze()
    if trace:
        first = len(losses)
        readings.trace, ks = profile_steps(program.step, first,
                                           traffic["trace_steps"], False)
        spans.on = True
        readings.span_trace, _ = profile_steps(program.step, ks[-1] + 1,
                                               traffic["trace_steps"], True)
        view, projection = scene.camera(traffic["half_width"],
                                        traffic["distance"], device)
        with torch.no_grad():
            for k in ks:
                clip = scene.clip_vertices(
                    data.homogeneous, data.pool[k % traffic["pool"]], view,
                    projection)
                readings.traced_coverage.append(forward.coverage(
                    clip, data.faces, config["height"], config["width"]))

    kept_outputs = program.outputs
    del program, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = check.reference_outputs(cell, data, kept)
    values = check.numbers(kept_outputs, want)
    failed = sum(1 for loss in losses if not math.isfinite(loss))
    return Result(readings=readings, steps=len(losses), failed=failed,
                  numbers=values,
                  correct=failed == 0 and check.judge(values, cell.limits),
                  device=dict(memory_peak_bytes=max(setup_peak,
                                                    readings.peak_bytes)))


def metrics(readings, entries, bench_dir=spec.BENCH_DIR):
    """{name: {"value", "unit"}} of the metric entries whose reader finds
    something to read."""
    out = {}
    for entry in entries:
        value = spec.metric_reader(entry["name"], bench_dir)(readings)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out
