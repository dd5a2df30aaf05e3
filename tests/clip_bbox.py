"""The port's near/far-clipped pixel bboxes held by what they promise.

dirt_tpu gives a face with a corner at w <= 0 the full screen as its
pixel bbox; the port (forward_pallas.pixel_bbox) gives it the box of its
part inside -w <= z <= w.  Tests that hold a table or a packing against
dirt_tpu keep its parity on every other face and column, and hold these
faces' bboxes by containment: every pixel a face covers (and, for a
bbox widened for the gradient's dilation, every pixel within that many
pixels of one) lies in its bbox, and a face whose bbox is empty covers
nothing.  The packing of the port's table is held to dirt_tpu's own
packing of that table (packed_on).  Imported by the test files beside
it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dirt_tpu_torch.ops import geometry


def unbounded(vertices, faces):
    """[B, F] numpy bool: the faces with a corner at w <= 0."""
    w = geometry.gather_corners(torch.as_tensor(vertices).float(),
                                torch.as_tensor(faces))[..., 3]
    return (w <= 0).any(dim=-1).numpy()


def coverage(vertices, faces, height, width):
    """[B, F, H, W] bool: the pixel centres each face covers."""
    setup = geometry.face_setup(torch.as_tensor(vertices).float(),
                                torch.as_tensor(faces))
    x, y = geometry.pixel_centre_ndc(height, width)
    face = lambda a: a[:, :, None, None]
    covered, _ = geometry.fragment_cover_depth(
        face(setup.e), face(setup.z), face(setup.w), face(setup.accept),
        face(setup.valid), x[None, None, None, :], y[None, None, :, None])
    return covered.numpy()


def dilated(covered, pixels):
    """`covered` [..., H, W] grown by `pixels` (Chebyshev)."""
    out = covered.copy()
    height, width = covered.shape[-2:]
    for dr in range(-pixels, pixels + 1):
        for dc in range(-pixels, pixels + 1):
            shifted = np.zeros_like(covered)
            shifted[..., max(dr, 0):height + min(dr, 0),
                    max(dc, 0):width + min(dc, 0)] = covered[
                ..., max(-dr, 0):height + min(-dr, 0),
                max(-dc, 0):width + min(-dc, 0)]
            out |= shifted
    return out


def assert_contained(vertices, faces, bbox, height, width, dilate=0,
                     only=None):
    """Every pixel within `dilate` of one that a face covers lies in its
    bbox (r0, r1, c0, c1: [B, F] arrays), over the faces of `only` ([B,
    F] bool; all where None); a face with an empty bbox covers nothing.
    Returns the covered (pixel, face) pairs checked."""
    covered = coverage(vertices, faces, height, width)
    if only is not None:
        covered &= np.asarray(only)[..., None, None]
    need = dilated(covered, dilate) if dilate else covered
    r0, r1, c0, c1 = (np.asarray(b)[..., None, None] for b in bbox)
    rows = np.arange(height)[:, None]
    cols = np.arange(width)[None, :]
    inside = (rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)
    outside = need & ~inside
    assert not outside.any(), (
        f"{int(outside.sum())} pixels outside their face's bbox, faces "
        f"{sorted(set(np.nonzero(outside)[1].tolist()))[:10]}")
    return int(covered.sum())


def assert_table_parity(got, want, bbox_cols, vertices, faces):
    """The port's face table `got` [B, R, D] == dirt_tpu's `want` bit for
    bit, but for the bbox columns of the faces with a corner at w <= 0
    (the first F rows are the faces, the rest pad rows)."""
    got, want = np.asarray(got), np.asarray(want)
    free = np.zeros(got.shape, bool)
    crossing = unbounded(vertices, faces)
    for col in bbox_cols:
        free[:, :crossing.shape[1], col] = crossing
    np.testing.assert_array_equal(got[~free].view(np.int32),
                                  want[~free].view(np.int32))


def packed_on(tables, module, table_fn, pack, *images, monkeypatch):
    """dirt_tpu's packing `pack` of a batch (vmapped over `images`) with
    its face table function `module.<table_fn>` giving the port's
    `tables` [B, R, D]: dirt_tpu's own binning of the port's bboxes."""
    def one(table, *image):
        monkeypatch.setattr(module, table_fn, lambda *args, **kw: table)
        return pack(*image)
    return jax.vmap(one)(jnp.asarray(np.asarray(tables)), *images)
