"""The yardstick of the kernels' roofline shares: the H100's peaks, the
least time a piece of work can take, and the bytes and operations that
the functions of K1 (the forward sweep, raster_sweep) and K3 (the
face-major gradient reduction, grad_reduce) need on the cell's inputs.

The counts are functions of the inputs alone, through the plain
reference's coverage of them (reference.forward.coverage): the
fragments, the (pixel, face) pairs in which a face covers a pixel
centre, and the covered pixels.  They do not read the port's schedule
(its face blocks, tiles, runs or launch shapes), so a change inside the
port leaves them valid.  Each input byte is counted read once and each
output byte written once, and the operations are those the inputs need:
a depth test at each fragment, the sums at each covered pixel.
"""

# The H100 SXM's published peaks: device memory 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = 67e9
# Operations per unit of work, every arithmetic, compare, select and
# logic operation of the kernels' expression trees:
OPS_FACE_TEST = 48     # one fragment's coverage and depth test
OPS_POSITION_HIT = 31  # the position sums of one covered pixel
OPS_COLOUR_HIT = 6     # per channel, the colour sums of one covered pixel
# Floats of a face the sweep needs (edge coefficients, z, w, bbox and
# the colours' plane constants: the 24-float face row), and of its
# per-pixel state beside the channels (depth, face id, barycentric
# numerators and the rest: channels + 9).
SWEEP_FACE_FLOATS = 24
SWEEP_STATE_EXTRA = 9
# Floats of a face the reduction needs: its bbox (4), id, valid flag and
# its corners' clip x and y (6); its per-pixel planes: 12 position and
# coverage planes plus one per colour channel; its output row: 9
# position terms plus 3 per colour channel.
REDUCE_FACE_FLOATS = 12
REDUCE_PLANES_BASE = 12
REDUCE_ROW_BASE = 9


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations"): the bytes over the memory rate
    or the operations over the float32 rate, whichever is longer."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_MS, ops / PEAK_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sweep_work(fragments, covered, batch, num_faces, height, width,
               channels):
    """(bytes, operations) of the forward sweep's function: each face's
    row read once, each pixel's state written once, and a coverage and
    depth test at each fragment."""
    nbytes = 4 * (batch * num_faces * SWEEP_FACE_FLOATS
                  + batch * height * width * (channels + SWEEP_STATE_EXTRA))
    return nbytes, fragments * OPS_FACE_TEST


def reduce_work(fragments, covered, batch, num_faces, height, width,
                channels):
    """(bytes, operations) of the gradient reduction's function with
    `channels` colour channels: each face's row read once and its output
    row written once, the planes of each covered pixel read once, and a
    covered pixel's position and colour sums once.  The pixels the
    occluder dilation adds (a few at the silhouettes) are left out."""
    nbytes = 4 * (covered * (REDUCE_PLANES_BASE + channels)
                  + batch * num_faces * (REDUCE_FACE_FLOATS
                                         + REDUCE_ROW_BASE + 3 * channels))
    return nbytes, covered * (OPS_POSITION_HIT + OPS_COLOUR_HIT * channels)
