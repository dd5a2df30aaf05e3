"""ops.forward.hits.stream_ms: stream ms a traced step in the port's
dirt.forward.hits span (forward_blocks._table_and_hits): K4 at dilation
0, which writes the [B, T, NB] block hits itself, and the zero-fill of
its output, by the span's CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.forward.hits")
