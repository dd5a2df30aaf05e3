"""ops.backward.device_ms: device ms a traced step of the operations
launched inside the span around loss.backward(): the pre-pass (K2), the
gradient pack and K3, the scatter, the scene math's and the shader's
backward."""

from bench_h100.harness.placed import placed_ms


def read(readings):
    return placed_ms(readings.span_trace, "backward")
