"""ops.forward.sweep.stream_ms: stream ms a traced step in the port's
dirt.forward.sweep and dirt.forward.finalize spans
(forward_blocks.rasterise_batch): the sweep (K1) and finalize, by the
spans' CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.forward.sweep", "dirt.forward.finalize")
