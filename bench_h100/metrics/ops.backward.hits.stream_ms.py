"""ops.backward.hits.stream_ms: stream ms a traced step in the port's
dirt.backward.hits span (grad_blocks._table_and_hits): K4 at dilation 1,
which writes the block hits itself, and the zero-fill of its output, by
the span's CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.backward.hits")
