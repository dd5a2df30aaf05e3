"""Brute-force forward rasteriser, plain PyTorch.

Every face is tested against every pixel centre that can lie in it: faces
go in chunks of CHUNK, and each chunk is tested only inside its window,
the pixels within MARGIN of its faces' projected bounding box (the whole
image where a corner lies at or behind the camera plane, w <= 0).  A
pixel centre outside that box is outside every face of the chunk, so the
winner map is the one the face-by-face scan over the whole image gives:
the lexicographic (depth, face index) minimum, GL_LESS, ties to the
earliest face.
"""

from typing import NamedTuple

import torch

from . import geometry

CHUNK = 256
MARGIN = 2   # pixels around a chunk's bbox, far above float rounding


class RasterAux(NamedTuple):
    """Per-pixel residuals of the forward, as the gradient reads them."""
    face_index: torch.Tensor   # [B, H, W] int32, -1 where background
    indices: torch.Tensor      # [B, H, W, 3] int32 vertex ids, -1 bg
    barycentric: torch.Tensor  # [B, H, W, 3] perspective-correct, -1 bg
    clip_w: torch.Tensor       # [B, H, W] fragment clip w, +inf bg


def chunk_windows(vertices, faces, height, width, chunk=CHUNK):
    """[B, NC, 5] int64 windows of each image's face chunks: (row0, row1,
    col0, col1) inclusive and a flag that is 1 where the window is empty
    (the chunk's box lies off the image)."""
    corners = geometry.gather_corners(vertices.float(), faces)   # [B,F,3,4]
    w = corners[..., 3]
    safe_w = torch.where(w > 0, w, 1.0)
    col = (corners[..., 0] / safe_w + 1.0) * (width / 2.0) - 0.5
    row = (1.0 - corners[..., 1] / safe_w) * (height / 2.0) - 0.5
    unbounded = (w <= 0).any(dim=-1)
    batch, num_faces = faces.shape[:2]
    pad = -num_faces % chunk

    def chunked(values, fill, reduce):
        values = torch.nn.functional.pad(values, (0, pad), value=fill)
        return reduce(values.reshape(batch, -1, chunk), dim=-1)

    big = float("inf")
    c0 = torch.floor(chunked(col.amin(-1), big, torch.amin)) - MARGIN
    c1 = torch.ceil(chunked(col.amax(-1), -big, torch.amax)) + MARGIN
    r0 = torch.floor(chunked(row.amin(-1), big, torch.amin)) - MARGIN
    r1 = torch.ceil(chunked(row.amax(-1), -big, torch.amax)) + MARGIN
    whole = chunked(unbounded.float(), 0.0, torch.amax) > 0
    empty = (c0 > width - 1) | (c1 < 0) | (r0 > height - 1) | (r1 < 0)
    empty = empty & ~whole
    clamp = lambda v, top, fill: torch.where(
        whole, fill, v.clamp(0, top)).long()
    return torch.stack([clamp(r0, height - 1, 0),
                        clamp(r1, height - 1, height - 1),
                        clamp(c0, width - 1, 0),
                        clamp(c1, width - 1, width - 1),
                        empty.long()], dim=-1)


def visibility(setup, vertices, faces, height, width, chunk=CHUNK,
               fragments=None):
    """Winning face index [B, H, W] int32 (-1 where no face wins); adds
    to the list `fragments`, if given, each chunk's count of covered
    (pixel, face) pairs."""
    batch, num_faces = setup.valid.shape
    device = setup.e.device
    x_ndc, y_ndc = geometry.pixel_centre_ndc(height, width, device)
    best_depth = torch.full((batch, height, width), 1.0, device=device)
    best_index = torch.full((batch, height, width), -1, dtype=torch.int32,
                            device=device)
    big = torch.iinfo(torch.int32).max
    windows = chunk_windows(vertices, faces, height, width, chunk).tolist()
    for b in range(batch):
        for k, (r0, r1, c0, c1, empty) in enumerate(windows[b]):
            if empty:
                continue
            f0, f1 = k * chunk, min((k + 1) * chunk, num_faces)
            face = lambda a: a[b, f0:f1, None, None]     # [K, 1, 1, ...]
            xg = x_ndc[None, None, c0:c1 + 1]
            yg = y_ndc[None, r0:r1 + 1, None]
            covered, depth = geometry.fragment_cover_depth(
                face(setup.e), face(setup.z), face(setup.w),
                face(setup.accept), face(setup.valid), xg, yg)
            if fragments is not None:
                fragments.append(covered.sum())
            chunk_depth = depth.amin(dim=0)
            ids = torch.arange(f0, f1, dtype=torch.int32,
                               device=device)[:, None, None]
            at_best = covered & (depth == chunk_depth[None])
            chunk_index = torch.where(at_best, ids, big).amin(dim=0)
            depth_view = best_depth[b, r0:r1 + 1, c0:c1 + 1]
            index_view = best_index[b, r0:r1 + 1, c0:c1 + 1]
            better = (chunk_depth < torch.inf) & (
                (chunk_depth < depth_view)
                | ((chunk_depth == depth_view) & (chunk_index < index_view)))
            depth_view.copy_(torch.where(better, chunk_depth, depth_view))
            index_view.copy_(torch.where(better, chunk_index, index_view))
    return best_index


def shade(best_index, setup, faces, vertex_colors, background):
    """Interpolates the winners' attributes and composites over the
    background: (pixels [B, H, W, C], RasterAux)."""
    batch, height, width = best_index.shape
    device = background.device
    x_ndc, y_ndc = geometry.pixel_centre_ndc(height, width, device)
    xg, yg = x_ndc[None, None, :], y_ndc[None, :, None]
    covered = best_index >= 0
    safe_index = best_index.clamp(min=0).long()
    b = torch.arange(batch, device=device)[:, None, None]
    e = setup.e[b, safe_index]                           # [B, H, W, 3, 3]
    w = setup.w[b, safe_index]                           # [B, H, W, 3]
    tri = faces[b, safe_index]                           # [B, H, W, 3]
    corner_colors = vertex_colors[b[..., None], tri.long()]
    interpolated = geometry.interpolate_attributes(e, xg, yg, corner_colors)
    pixels = torch.where(covered[..., None], interpolated, background)
    bary, clip_w = geometry.fragment_barycentrics(e, xg, yg, w)
    return pixels, RasterAux(
        face_index=best_index,
        indices=torch.where(covered[..., None], tri.int(), -1),
        barycentric=torch.where(covered[..., None], bary, -1.0),
        clip_w=torch.where(covered, clip_w, torch.inf))


def rasterise_batch(background, vertices, vertex_colors, faces):
    """(pixels [B, H, W, C], RasterAux) of a batch of meshes."""
    height, width = background.shape[1:3]
    setup = geometry.face_setup(vertices, faces)
    best_index = visibility(setup, vertices, faces, height, width)
    return shade(best_index, setup, faces, vertex_colors, background)


def coverage(vertices, faces, height, width):
    """(fragments, covered pixels) of a batch: the (pixel, face) pairs in
    which a face covers a pixel centre, and the pixels some face wins."""
    setup = geometry.face_setup(vertices, faces)
    counts = []
    best_index = visibility(setup, vertices, faces, height, width,
                            fragments=counts)
    fragments = int(torch.stack(counts).sum()) if counts else 0
    return fragments, int((best_index >= 0).sum())
