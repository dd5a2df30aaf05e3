"""Brute-force rasteriser: the CPU backend and the plain oracle on the card
(PyTorch port of dirt_tpu/ops/reference.py).

Every face is tested against every pixel with the fragment semantics of
ops/geometry.py.  The JAX module scans faces one at a time; here faces are
swept in chunks of CHUNK as [B, CHUNK, H, W] planes, each chunk reduced to
its lexicographic (depth, face index) minimum and merged into the running
winner.  The lexicographic minimum is associative, so the winner map is
the one the face-by-face scan produces.
"""

from typing import NamedTuple

import torch

from . import geometry

CHUNK = 64


class RasterAux(NamedTuple):
    """Residuals the backward pass needs, plus the silent-cap diagnostic
    ``dropped``: per image, the face visits the work schedule could not
    materialise (0 for exact schedules).  See dirt_tpu/ops/reference.py."""
    face_index: torch.Tensor   # [*, H, W] int32, -1 where background
    indices: torch.Tensor      # [*, H, W, 3] int32 vertex-index triple, -1 bg
    barycentric: torch.Tensor  # [*, H, W, 3] perspective-correct, -1 bg
    clip_w: torch.Tensor       # [*, H, W] fragment clip-space w, +inf bg
    dropped: torch.Tensor = None  # [*] int32 dropped face visits


def visibility_scan(setup: geometry.FaceSetup, height, width):
    """Winning face index per pixel for a batch.

    Args:
        setup: FaceSetup with leading dims [B, F].
        height, width: image size.

    Returns:
        best_index [B, H, W] int32 (-1 where no face wins).
    """
    batch, num_faces = setup.valid.shape
    device = setup.e.device
    x_ndc, y_ndc = geometry.pixel_centre_ndc(height, width, device)
    xg = x_ndc[None, None, None, :]                      # [1, 1, 1, W]
    yg = y_ndc[None, None, :, None]                      # [1, 1, H, 1]
    best_depth = torch.full((batch, height, width), 1.0, device=device)
    best_index = torch.full((batch, height, width), -1, dtype=torch.int32,
                            device=device)
    big = torch.iinfo(torch.int32).max
    for f0 in range(0, num_faces, CHUNK):
        f1 = min(f0 + CHUNK, num_faces)
        face = lambda a: a[:, f0:f1, None, None]        # [B, K, 1, 1, ...]
        covered, depth = geometry.fragment_cover_depth(
            face(setup.e), face(setup.z), face(setup.w), face(setup.accept),
            face(setup.valid), xg, yg)                   # [B, K, H, W]
        # Chunk minimum, lexicographic in (depth, face index).
        chunk_depth = depth.amin(dim=1)
        ids = torch.arange(f0, f1, dtype=torch.int32,
                           device=device)[None, :, None, None]
        at_best = covered & (depth == chunk_depth[:, None])
        chunk_index = torch.where(at_best, ids, big).amin(dim=1)
        # GL_LESS against the running buffer; ties to the earliest face.
        better = (chunk_depth < torch.inf) & (
            (chunk_depth < best_depth)
            | ((chunk_depth == best_depth) & (chunk_index < best_index)))
        best_depth = torch.where(better, chunk_depth, best_depth)
        best_index = torch.where(better, chunk_index, best_index)
    return best_index


def shade_pixels(best_index, setup: geometry.FaceSetup, faces, vertex_colors,
                 background):
    """Interpolates attributes for the winning faces and composites.

    Args (batched): best_index [B, H, W] int32; setup with leading dims
    [B, F]; faces [B, F, 3]; vertex_colors [B, V, C]; background
    [B, H, W, C].  Returns (pixels [B, H, W, C], RasterAux).
    """
    batch, height, width = best_index.shape
    device = background.device
    if faces.shape[1] == 0:
        return background, RasterAux(
            face_index=torch.full((batch, height, width), -1,
                                  dtype=torch.int32, device=device),
            indices=torch.full((batch, height, width, 3), -1,
                               dtype=torch.int32, device=device),
            barycentric=torch.full((batch, height, width, 3), -1.0,
                                   device=device),
            clip_w=torch.full((batch, height, width), torch.inf,
                              device=device))

    x_ndc, y_ndc = geometry.pixel_centre_ndc(height, width, device)
    xg = x_ndc[None, None, :]
    yg = y_ndc[None, :, None]

    covered = best_index >= 0
    safe_index = best_index.clamp(min=0).long()
    b = torch.arange(batch, device=device)[:, None, None]
    e = setup.e[b, safe_index]                           # [B, H, W, 3, 3]
    w = setup.w[b, safe_index]                           # [B, H, W, 3]
    tri = faces[b, safe_index]                           # [B, H, W, 3]
    corner_colors = vertex_colors[b[..., None], tri.long()]  # [B,H,W,3,C]

    interpolated = geometry.interpolate_attributes(e, xg, yg, corner_colors)
    pixels = torch.where(covered[..., None], interpolated, background)

    bary, clip_w = geometry.fragment_barycentrics(e, xg, yg, w)
    aux = RasterAux(
        face_index=best_index,
        indices=torch.where(covered[..., None], tri.int(), -1),
        barycentric=torch.where(covered[..., None], bary, -1.0),
        clip_w=torch.where(covered, clip_w, torch.inf))
    return pixels, aux


def rasterise_batch(background, vertices, vertex_colors, faces):
    """Batched brute-force rasterisation ([B, ...] on every argument)."""
    height, width = background.shape[1], background.shape[2]
    setup = geometry.face_setup(vertices, faces)
    best_index = visibility_scan(setup, height, width)
    pixels, aux = shade_pixels(best_index, setup, faces, vertex_colors,
                               background)
    # Exact by construction: every face is swept against every pixel.
    return pixels, aux._replace(dropped=torch.zeros(
        background.shape[0], dtype=torch.int32, device=background.device))
