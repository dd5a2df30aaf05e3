"""texture.fetches_per_texel: the bilinear sampler's texel fetches a step,
8 x B x H x W (four corner gathers forward and four scatter-adds
backward at every pixel), over the distinct texels its texture gradient
scatters into (the port's texture.texels_touched counter, in the
dirt.texture.sample_grad span): the reuse that sets the scatter's atomic
contention, over the traced steps."""

from bench_h100.harness.stages import counted

FETCHES_PER_POINT = 8


def read(readings):
    touched = counted(readings, "texture.texels_touched")
    if not touched:
        return None
    points = readings.batch * readings.height * readings.width
    return FETCHES_PER_POINT * points * readings.trace.steps / touched
