"""The port's own stage spans and schedule counters of a traced run, read
from dirt_tpu_torch.utils.profiling.records() in the benchmark's process.

The port records spans only while a torch.profiler session is active: in
a traced run, the device-only profile's steps and then the profile with
the host's activity (runner.measure).  The readers take the first
`readings.trace.steps` steps, the device-only profile's, whose host
activity the profiler does not record: the records that start before the
next step's "dirt.forward" entry span.  They read nothing where the port
records no spans (a port without them), or where the run did not record
exactly one "dirt.forward" a traced step of both profiles (a profile
taken again, or another entry point).
"""

ENTRY = "dirt.forward"


def traced_records(readings):
    """The port's span records of the device-only profile's steps, by host
    start, or None."""
    if readings.trace is None or readings.span_trace is None:
        return None
    try:
        from dirt_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    spans = sorted(read(), key=lambda r: r.start_ns)
    entries = [r for r in spans if r.name == ENTRY]
    steps = readings.trace.steps
    if len(entries) != steps + readings.span_trace.steps:
        return None
    cut = entries[steps].start_ns
    return [r for r in spans if r.start_ns < cut]


def stream_ms(readings, *names):
    """Stream ms a step in the spans named `names`; None without records,
    without such a span, or where one ran on no card."""
    spans = traced_records(readings)
    if spans is None:
        return None
    chosen = [r for r in spans if r.name in names]
    if not chosen or any(r.stream_ms is None for r in chosen):
        return None
    return sum(r.stream_ms for r in chosen) / readings.trace.steps


def host_ms(readings, *names):
    """Host wall ms a step in the spans named `names`; None without
    records or without such a span."""
    spans = traced_records(readings)
    if spans is None:
        return None
    chosen = [r for r in spans if r.name in names]
    if not chosen:
        return None
    return sum(r.end_ns - r.start_ns for r in chosen) * 1e-6 / (
        readings.trace.steps)


def counted(readings, *names):
    """The sum of the counters named `names` over the steps; None without
    records or where no span counted any of them."""
    spans = traced_records(readings)
    if spans is None:
        return None
    values = [r.counters[name] for r in spans for name in names
              if name in r.counters]
    return sum(values) if values else None
