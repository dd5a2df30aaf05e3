"""texture.sample.stream_ms: stream ms a traced step in the port's
dirt.texture.sample span (utils/textures, the sampler's forward): the
four corner gathers (index_select) and the bilinear blend of every
pixel, by the span's CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.texture.sample")
