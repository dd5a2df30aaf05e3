"""texture.sample.roofline_pct: the bilinear sampler's least time a step
over its stream ms a step in the port's dirt.texture.sample and
dirt.texture.sample_grad spans, in %.

The harness places a trace's launches in its own record_function spans
(the step's "shader" and "backward"), not in the port's spans, so the
device time is the two spans' stream ms (harness/stages.py: their CUDA
events, device work and any wait for the host inside them).

The least time is each half's bytes at 3.35 TB/s or its operations at
67 TFLOP/s f32, whichever is longer (harness/work.bound), summed over the
two halves.  The counts are functions of the points, B x H x W (the
shader samples every pixel, background too), and of the configuration's
texture alone; each input byte is counted read once and each output
byte written once:

  forward   indices (2 floats) and the output (C) a point, the texture
            read once;
  backward  the output gradient (C), the indices (2) and their gradient
            (2) a point, the texture gradient written once.

Operations, from the sampler's expressions (dirt_tpu_torch/utils/
textures.py), a point: floor, the fraction and the weights 1 - f, 6 in
each half (the index arithmetic on integers left out); a channel, the
blend's 8 products and 3 sums forward, and backward the texture
gradient's 8 products and 4 scatter-adds, the row gradient's 8 products
and 4 sums and the column gradient's 4 products and 4 sums (its g x
weight products are the texture gradient's).  The bytes bound both
halves at the cell's shapes by about two orders of magnitude.
"""

from bench_h100.harness.stages import stream_ms
from bench_h100.harness.work import bound

INDEX_FLOATS = 2
OPS_POINT = 6
OPS_CHANNEL_FORWARD = 11
OPS_CHANNEL_BACKWARD = 32
SPANS = ("dirt.texture.sample", "dirt.texture.sample_grad")


def sample_work(points, texels, channels):
    """(bytes, operations) of the forward at `points` points of a texture
    of `texels` texels and `channels` channels."""
    nbytes = 4 * (points * (INDEX_FLOATS + channels) + texels * channels)
    return nbytes, points * (OPS_POINT + OPS_CHANNEL_FORWARD * channels)


def sample_grad_work(points, texels, channels):
    """(bytes, operations) of the backward."""
    nbytes = 4 * (points * (channels + 2 * INDEX_FLOATS)
                  + texels * channels)
    return nbytes, points * (OPS_POINT + OPS_CHANNEL_BACKWARD * channels)


def least_ms(points, texels, channels):
    """The least ms of a forward and a backward."""
    return sum(bound(*work(points, texels, channels))[0]
               for work in (sample_work, sample_grad_work))


def read(readings):
    spans = [stream_ms(readings, name) for name in SPANS]
    texture = readings.cell.config.get("texture")
    if None in spans or texture is None or sum(spans) <= 0:
        return None
    points = readings.batch * readings.height * readings.width
    least = least_ms(points, texture["height"] * texture["width"],
                     texture["channels"])
    return 100.0 * least / sum(spans)
