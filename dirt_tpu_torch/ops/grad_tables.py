"""The gradient face table (from dirt_tpu/ops/grad_tables.py).

Per-face constants for the block-binned gradient reduction, with pixel
bboxes widened one pixel for dilation support.  Columns:
  [0:4]  bbox (r0, r1, c0, c1)   [4] original face index   [5] valid
  [6:9]  corner clip x           [9:12] corner clip y
  [12:21] the 9 edge coefficients (read only by the binning's cull)
"""

import torch

from . import forward_pallas, geometry

_BIG = forward_pallas._BIG
_DF = 21


def _grad_face_table(vertices, faces, height, width, pad_rows):
    """[B, F + pad_rows, _DF] float32; padded rows get an empty bbox and
    original index -1."""
    batch, num_faces = faces.shape[:2]
    device = vertices.device
    setup = geometry.face_setup(vertices, faces)

    corners = geometry.gather_corners(vertices, faces)    # [B, F, 3, 4]
    w = corners[..., 3]
    safe_w = torch.where(w > 0, w, 1.0)
    px = (corners[..., 0] / safe_w + 1.0) * (width / 2.0)
    py = (1.0 - corners[..., 1] / safe_w) * (height / 2.0)

    unbounded = (w <= 0).any(dim=-1)
    i32 = lambda a: a.to(torch.int32)
    col0 = i32(torch.floor(px.amin(dim=-1) - 0.5)) - 1
    col1 = i32(torch.ceil(px.amax(dim=-1) - 0.5)) + 1
    row0 = i32(torch.floor(py.amin(dim=-1) - 0.5)) - 1
    row1 = i32(torch.ceil(py.amax(dim=-1) - 0.5)) + 1
    # Dilation can move a face's gradient support one pixel beyond its
    # rasterised footprint: widen the bbox by an extra pixel.
    col0 = torch.where(unbounded, 0, (col0 - 1).clamp(0, width - 1))
    col1 = torch.where(unbounded, width - 1, (col1 + 1).clamp(0, width - 1))
    row0 = torch.where(unbounded, 0, (row0 - 1).clamp(0, height - 1))
    row1 = torch.where(unbounded, height - 1,
                       (row1 + 1).clamp(0, height - 1))

    valid = setup.valid
    row0 = torch.where(valid, row0, _BIG)
    col0 = torch.where(valid, col0, _BIG)
    row1 = torch.where(valid, row1, -1)
    col1 = torch.where(valid, col1, -1)

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
    pad[0] = pad[2] = float(_BIG)
    pad[1] = pad[3] = pad[4] = -1.0
    return torch.cat([face_data, pad.expand(batch, pad_rows, _DF)], dim=1)
