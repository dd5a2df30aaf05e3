"""The brute-force forward for cameras inside the mesh, plain PyTorch,
under autograd.

reference.forward gives a chunk with a corner at w <= 0 the whole image
as its window.  A face covers a pixel only where its point on the
pixel's ray has w > 0 and -w <= z <= w, so the pixels it covers lie in
the projection of the face clipped to those two planes.  Here each
chunk's window is the box of its faces' clipped parts, projected, grown
by forward.MARGIN pixels; a face is clipped by the points its part can
have as corners: its corners inside both planes, its edges' crossings of
one plane inside the other, and, where the crossing of the near plane
reaches w <= 0, a point at w = 0, which projects off every image and
gives the chunk the whole image.  Every test of a point against a plane
admits a margin, so the box holds the part's rounding.  The winner map
is the one the face-by-face scan over the whole image gives; only the
windows differ from reference.forward.  The gradient is
reference.gradient's.
"""

import torch

from . import forward, geometry, gradient

# Relative margin of a point's test against a plane, far above float32
# rounding of the corners' sums.
SLACK = 2.0 ** -12
_EDGES = ((0, 1), (1, 2), (2, 0))


def face_bounds(corners, height, width):
    """Per face of `corners` [B, F, 3, 4]: (col0, col1, row0, row1)
    float32, the least and greatest pixel coordinates of its clipped
    part's corners (+inf, -inf where it has none), and `whole` [B, F]
    bool, where a corner can reach w <= 0 or project off the float
    range."""
    x, y, z, w = corners.unbind(-1)
    near, far = z + w, w - z                       # >= 0 inside
    slack = SLACK * (z.abs() + w.abs())
    points = [corners]
    live = [(near >= -slack) & (far >= -slack)]
    whole = torch.zeros(corners.shape[:2], dtype=torch.bool,
                        device=corners.device)
    for plane, sign in ((near, -1.0), (far, 1.0)):
        for i, j in _EDGES:
            di, dj = plane[..., i], plane[..., j]
            crosses = (di >= 0) != (dj >= 0)
            t = (di / (di - dj))[..., None]
            start, end = corners[..., i, :], corners[..., j, :]
            point = start + t * (end - start)
            pz, pw = point[..., 2], point[..., 3]
            # The crossing lies inside the other plane: w + sign z >= 0.
            inside = pw + sign * pz >= -SLACK * (pz.abs() + pw.abs())
            if sign < 0:
                whole |= crosses & (pw <= SLACK * pz.abs())
            points.append(point[..., None, :])
            live.append((crosses & inside)[..., None])
    points, live = torch.cat(points, -2), torch.cat(live, -1)
    px = (points[..., 0] / points[..., 3] + 1.0) * (width / 2.0) - 0.5
    py = (1.0 - points[..., 1] / points[..., 3]) * (height / 2.0) - 0.5
    whole |= (live & ((points[..., 3] <= 0) | ~torch.isfinite(px)
                      | ~torch.isfinite(py))).any(-1)
    big = torch.inf
    least = lambda p: torch.where(live, p, big).amin(-1)
    most = lambda p: torch.where(live, p, -big).amax(-1)
    return least(px), most(px), least(py), most(py), whole


def chunk_windows(vertices, faces, height, width, chunk=forward.CHUNK):
    """forward.chunk_windows' [B, NC, 5] int64 windows (row0, row1, col0,
    col1 inclusive, and 1 where empty), each from its chunk's clipped
    faces (face_bounds): empty where no face keeps a part in the image,
    the whole image where one is `whole`."""
    corners = geometry.gather_corners(vertices.float(), faces)
    col0, col1, row0, row1, whole = face_bounds(corners, height, width)
    batch, num_faces = faces.shape[:2]
    pad = -num_faces % chunk

    def chunked(values, fill, reduce):
        values = torch.nn.functional.pad(values, (0, pad), value=fill)
        return reduce(values.reshape(batch, -1, chunk), dim=-1)

    big = float("inf")
    c0 = torch.floor(chunked(col0, big, torch.amin)) - forward.MARGIN
    c1 = torch.ceil(chunked(col1, -big, torch.amax)) + forward.MARGIN
    r0 = torch.floor(chunked(row0, big, torch.amin)) - forward.MARGIN
    r1 = torch.ceil(chunked(row1, -big, torch.amax)) + forward.MARGIN
    whole = chunked(whole.float(), 0.0, torch.amax) > 0
    empty = ((c0 > width - 1) | (c1 < 0) | (r0 > height - 1) | (r1 < 0)
             | (c0 > c1)) & ~whole
    clamp = lambda v, top, fill: torch.where(
        whole | empty, fill, v.clamp(0, top)).long()
    return torch.stack([clamp(r0, height - 1, 0),
                        clamp(r1, height - 1, height - 1),
                        clamp(c0, width - 1, 0),
                        clamp(c1, width - 1, width - 1),
                        empty.long()], dim=-1)


def visibility(setup, windows, height, width, chunk=forward.CHUNK):
    """forward.visibility over the windows `windows` ([B, NC, 5] as a
    list): the winning face index [B, H, W] int32, -1 where none wins."""
    batch, num_faces = setup.valid.shape
    device = setup.e.device
    x_ndc, y_ndc = geometry.pixel_centre_ndc(height, width, device)
    best_depth = torch.full((batch, height, width), 1.0, device=device)
    best_index = torch.full((batch, height, width), -1, dtype=torch.int32,
                            device=device)
    big = torch.iinfo(torch.int32).max
    for b in range(batch):
        for k, (r0, r1, c0, c1, empty) in enumerate(windows[b]):
            if empty:
                continue
            f0, f1 = k * chunk, min((k + 1) * chunk, num_faces)
            face = lambda a: a[b, f0:f1, None, None]     # [K, 1, 1, ...]
            covered, depth = geometry.fragment_cover_depth(
                face(setup.e), face(setup.z), face(setup.w),
                face(setup.accept), face(setup.valid),
                x_ndc[None, None, c0:c1 + 1], y_ndc[None, r0:r1 + 1, None])
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


def rasterise_batch_plain(background, vertices, vertex_colors, faces):
    """(pixels [B, H, W, C], forward.RasterAux) of a batch of meshes, as
    forward.rasterise_batch gives them."""
    height, width = background.shape[1:3]
    setup = geometry.face_setup(vertices, faces)
    windows = chunk_windows(vertices, faces, height, width).tolist()
    best_index = visibility(setup, windows, height, width)
    return forward.shade(best_index, setup, faces, vertex_colors, background)


class _Rasterise(torch.autograd.Function):

    @staticmethod
    def forward(ctx, background, vertices, colors, faces):
        pixels, aux = rasterise_batch_plain(background, vertices, colors,
                                            faces)
        ctx.save_for_backward(vertices, pixels, *aux)
        return pixels

    @staticmethod
    def backward(ctx, grad_pixels):
        vertices, pixels, *aux = ctx.saved_tensors
        grad_background, grad_vertices, grad_colors = gradient.grad_grouped(
            vertices, pixels, grad_pixels.contiguous(),
            forward.RasterAux(*aux))
        return grad_background, grad_vertices, grad_colors, None


def rasterise_batch(background, vertices, colors, faces):
    """Pixels [B, H, W, C], differentiable in the background, the
    vertices and the colours (reference.autograd.rasterise_batch)."""
    return _Rasterise.apply(background, vertices, colors, faces)
