"""ops.forward.device_ms: device ms a traced step of the operations
launched inside the span around the entry-point call, the shader's own
span (deferred) left out: the forward pack (K4, the block-hit reduction,
the CSR runs), the sweep (K1) and finalize."""

from bench_h100.harness.placed import placed_ms


def read(readings):
    return placed_ms(readings.span_trace, "rasterise")
