"""ops.forward.pack.stream_ms: stream ms a traced step in the port's
dirt.forward.table and dirt.forward.runs spans (forward_blocks): the face
table, the Morton sort and its gather, and the CSR runs (build_runs), by
the spans' CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.forward.table", "dirt.forward.runs")
