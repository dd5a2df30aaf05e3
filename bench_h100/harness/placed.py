"""Shared arithmetic of the per-layer metric readers."""

from .work import bound

# A span's device time is read only where the launches of nearly all the
# traced device time were placed in a span.
MAX_UNPLACED = 0.01


def placed_ms(trace, span):
    """Device ms a traced step launched in `span`; None without a trace,
    with no operation in the span, or where too much device time could
    not be placed."""
    if trace is None or not trace.ops or trace.unplaced_share() > MAX_UNPLACED:
        return None
    if not any(op.span == span for op in trace.ops):
        return None
    return trace.span_ms(span)


def roofline_pct(readings, kernel, work):
    """100 x the least time of `work` (work.sweep_work or reduce_work)
    summed over the traced steps' inputs, over the device time of the
    kernels named `kernel` on those steps; None where the trace holds no
    such kernel."""
    trace = readings.trace
    if trace is None:
        return None
    device_ms = trace.kernel_ms(kernel) * trace.steps
    if device_ms <= 0:
        return None
    least_ms = sum(bound(*work(fragments, covered, readings.batch,
                               readings.num_faces, readings.height,
                               readings.width, readings.channels))[0]
                   for fragments, covered in readings.traced_coverage)
    return 100.0 * least_ms / device_ms
