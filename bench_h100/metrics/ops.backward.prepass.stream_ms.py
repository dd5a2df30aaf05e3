"""ops.backward.prepass.stream_ms: stream ms a traced step in the port's
dirt.backward.prepass span (grad_blocks.rasterise_grad_batch): the
pre-pass (K2) and the background gradient, by the span's CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.backward.prepass")
