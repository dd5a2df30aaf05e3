"""ops.forward.device_ms: device ms a traced step of the operations
launched inside the span around the entry-point call, the shader's own
span (where the entry point shades) left out: the forward pack (the face
table, K4 and its block hits, the CSR runs), the sweep (K1) and
finalize."""

from bench_h100.harness.placed import placed_ms


def read(readings):
    return placed_ms(readings.span_trace, "rasterise")
