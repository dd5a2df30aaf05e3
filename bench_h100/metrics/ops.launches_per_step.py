"""ops.launches_per_step: device operations (kernels, memsets, copies) a
traced step, from the profiler's device trace."""


def read(readings):
    trace = readings.trace
    if trace is None or not trace.ops:
        return None
    return len(trace.ops) / trace.steps
