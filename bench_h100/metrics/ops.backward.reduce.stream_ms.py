"""ops.backward.reduce.stream_ms: stream ms a traced step in the port's
dirt.backward.reduce and dirt.backward.scatter spans (grad_blocks): the
face-major reduction (K3) and the scatter of face rows into vertex rows,
by the spans' CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.backward.reduce",
                     "dirt.backward.scatter")
