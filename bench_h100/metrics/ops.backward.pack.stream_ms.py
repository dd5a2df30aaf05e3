"""ops.backward.pack.stream_ms: stream ms a traced step in the port's
dirt.backward.table and dirt.backward.runs spans (grad_blocks): the
gradient face table, its Morton sort and the transposed CSR runs, by the
spans' CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.backward.table", "dirt.backward.runs")
