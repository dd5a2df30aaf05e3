"""texture.sample_grad.stream_ms: stream ms a traced step in the port's
dirt.texture.sample_grad span (utils/textures, the sampler's backward):
the texture gradient's four index_add_ scatters, the corners gathered
again for the index gradient, and, in a traced run, the texels_touched
counter's index_fill_, by the span's CUDA events."""

from bench_h100.harness.stages import stream_ms


def read(readings):
    return stream_ms(readings, "dirt.texture.sample_grad")
