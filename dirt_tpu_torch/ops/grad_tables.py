"""The gradient face table and its per-tile packing (from
dirt_tpu/ops/grad_tables.py).

Per-face constants for the gradient reductions (block-binned,
ops/grad_blocks.py, and tile-major dense, ops/grad_dense.py), with pixel
bboxes widened one pixel for dilation support.  Columns:
  [0:4]  bbox (r0, r1, c0, c1)   [4] original face index   [5] valid
  [6:9]  corner clip x           [9:12] corner clip y
  [12:21] the 9 edge coefficients (read only by the binning's cull)
"""

import torch

from . import forward_pallas, geometry

_DF = 21
_BBOX = (0, 1, 2, 3)


def _grad_face_table(vertices, faces, height, width, pad_rows):
    """[B, F + pad_rows, _DF] float32; padded rows get an empty bbox and
    original index -1."""
    batch, num_faces = faces.shape[:2]
    device = vertices.device
    setup = geometry.face_setup(vertices, faces)

    corners = geometry.gather_corners(vertices, faces)    # [B, F, 3, 4]
    valid = setup.valid
    # Dilation can move a face's gradient support one pixel beyond its
    # rasterised footprint: widen the bbox by an extra pixel.
    row0, row1, col0, col1 = forward_pallas.pixel_bbox(
        corners, valid, height, width, widen=1)

    f32 = lambda a: a.to(torch.float32)[..., None]
    orig = torch.arange(num_faces, dtype=torch.float32, device=device)
    face_data = torch.cat([
        f32(row0), f32(row1), f32(col0), f32(col1),
        orig.expand(batch, num_faces)[..., None],
        f32(valid),
        corners[..., 0],    # x0 x1 x2
        corners[..., 1],    # y0 y1 y2
        setup.e.reshape(batch, num_faces, 9),
    ], dim=-1)
    pad = torch.zeros(_DF, device=device)
    pad[0] = pad[2] = float(forward_pallas._BIG)
    pad[1] = pad[3] = pad[4] = -1.0
    return torch.cat([face_data, pad.expand(batch, pad_rows, _DF)], dim=1)


def _pack_grad_faces(vertices, faces, height, width, num_chunks, tiles_y,
                     tiles_x, chunk, tile_h, tile_w):
    """Exact per-tile hits-first face lists of the gradient table (see
    forward_pallas._pack_faces: row indices into one table per image; the
    table is forward_blocks.face_table's in face order, K13's rows on
    CUDA).

    Returns (face_data [B, F', _DF] f32, face_ids [B, T, num_chunks *
    chunk] int32 rows of it, counts [B, T] int32 cut to the slots,
    sorted_orig [B, T, num_chunks * chunk] int32 original face of each
    slot, 0 for padded rows).  A cut here is not counted: the forward over
    the same geometry reports it (its narrower bboxes give a near-subset
    of these lists) in RasterAux.dropped.
    """
    from . import forward_blocks
    num_faces = faces.shape[1]
    max_rows = num_chunks * chunk
    pad_rows = max(max_rows, num_faces) - num_faces
    face_data, _ = forward_blocks.face_table(vertices, faces, None, height,
                                             width, num_faces + pad_rows)
    overlap = forward_pallas.tile_overlap(face_data, _BBOX, tiles_y,
                                          tiles_x, tile_h, tile_w)
    face_ids, counts = forward_pallas.hits_first(overlap, max_rows)
    base_orig = torch.cat([
        torch.arange(num_faces, dtype=torch.int32, device=faces.device),
        torch.zeros(pad_rows, dtype=torch.int32, device=faces.device)])
    return (face_data, face_ids, counts.clamp(max=max_rows),
            base_orig[face_ids.long()])
