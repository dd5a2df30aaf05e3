"""The forward face-table layout (from dirt_tpu/ops/forward_pallas.py).

Only the table is ported: the "pallas" backend's per-face kernel is not on
the main path (ROADMAP queue 2).  The block-binned schedule
(ops/forward_blocks.py) and its sweep kernel read this layout.

Face-table layout, float32 per face:
  [0:9]   edge coefficients e (row-major 3x3)
  [9:12]  corner clip z        [12:15] corner clip w
  [15:18] fill-rule accept     [18]    valid flag
  [19]    original face index  [20:24] pixel bbox (r0, r1, c0, c1)
  [24:27] corner vertex ids    [27:27+3C] corner attributes (per corner:
                               corner0[0..C), corner1[0..C), corner2[0..C))
Floats encode ints exactly below 2^24.
"""

import torch

from . import geometry

_BASE = 27           # packed floats per face before corner attributes
_BIG = 1 << 30


def _pad_row(width_d, device=None):
    """A face-table row that no binning scheme selects and no kernel
    rasterises: zero everywhere (invalid flag) with an empty pixel bbox."""
    row = torch.zeros(width_d, dtype=torch.float32, device=device)
    row[20] = float(_BIG)
    row[22] = float(_BIG)
    row[21] = -1.0
    row[23] = -1.0
    return row


def _face_table(vertices, vertex_colors, faces, height, width, pad_rows):
    """Per-face raster constants + corner attributes for a batch:
    [B, F + pad_rows, _BASE + 3C] float32, with the conservative pixel bbox
    in columns 20-23 and padded rows given an empty bbox.

    Invalid (degenerate) rows get NaN z/w columns: the block schedule
    sweeps every row of a live block, and a degenerate face's rounded edge
    values can pass the fill rule; NaN s_z/s_w fail the |s_z| <= |s_w|
    test, which is what lets the sweep drop the valid-flag AND.
    """
    batch, num_faces = faces.shape[:2]
    channels = vertex_colors.shape[-1]
    device = vertices.device
    setup = geometry.face_setup(vertices, faces)

    corners = geometry.gather_corners(vertices, faces)    # [B, F, 3, 4]
    w = corners[..., 3]
    safe_w = torch.where(w > 0, w, 1.0)
    px = (corners[..., 0] / safe_w + 1.0) * (width / 2.0)
    py = (1.0 - corners[..., 1] / safe_w) * (height / 2.0)

    # Conservative pixel bbox (+/- 1 pixel of rounding slack); faces with
    # any w <= 0 may wrap through infinity, so they get the full screen.
    unbounded = (w <= 0).any(dim=-1)
    i32 = lambda a: a.to(torch.int32)
    col0 = i32(torch.floor(px.amin(dim=-1) - 0.5)) - 1
    col1 = i32(torch.ceil(px.amax(dim=-1) - 0.5)) + 1
    row0 = i32(torch.floor(py.amin(dim=-1) - 0.5)) - 1
    row1 = i32(torch.ceil(py.amax(dim=-1) - 0.5)) + 1
    col0 = torch.where(unbounded, 0, col0.clamp(0, width - 1))
    col1 = torch.where(unbounded, width - 1, col1.clamp(0, width - 1))
    row0 = torch.where(unbounded, 0, row0.clamp(0, height - 1))
    row1 = torch.where(unbounded, height - 1, row1.clamp(0, height - 1))

    valid = setup.valid
    row0 = torch.where(valid, row0, _BIG)
    col0 = torch.where(valid, col0, _BIG)
    row1 = torch.where(valid, row1, -1)
    col1 = torch.where(valid, col1, -1)

    corner_attrs = geometry.gather_corners(vertex_colors.float(), faces)
    keep = valid[..., None]
    f32 = lambda a: a.to(torch.float32)
    orig = torch.arange(num_faces, dtype=torch.float32, device=device)
    face_data = torch.cat([
        setup.e.reshape(batch, num_faces, 9),
        torch.where(keep, setup.z, torch.nan),
        torch.where(keep, setup.w, torch.nan),
        f32(setup.accept),
        f32(valid)[..., None],
        orig.expand(batch, num_faces)[..., None],
        f32(row0)[..., None], f32(row1)[..., None],
        f32(col0)[..., None], f32(col1)[..., None],
        f32(faces),
        corner_attrs.reshape(batch, num_faces, 3 * channels),
    ], dim=-1)
    pad = _pad_row(_BASE + 3 * channels, device).expand(
        batch, pad_rows, _BASE + 3 * channels)
    return torch.cat([face_data, pad], dim=1)
