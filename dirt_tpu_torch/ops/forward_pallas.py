"""The forward face table, the exact per-tile packing and the "pallas"
backend (PyTorch port of dirt_tpu/ops/forward_pallas.py).

The block-binned schedule (ops/forward_blocks.py) reads the table; the
"dense" backend (ops/forward_dense.py) and the "pallas" backend read it
through the per-tile face lists of _pack_faces.  The "pallas" backend is
dirt_tpu's original fused kernel: visibility over the tile's list, then
shading, in one kernel (pallas_raster, kernel K8 on CUDA) that writes the
pixels and the aux fields directly -- no per-pixel state, no finalize.
It uses the dense backend's GPU tile (16x16) and packing, so the two
differ only in the kernel, and their outputs are equal bit for bit.

Face-table layout, float32 per face:
  [0:9]   edge coefficients e (row-major 3x3)
  [9:12]  corner clip z        [12:15] corner clip w
  [15:18] fill-rule accept     [18]    valid flag
  [19]    original face index  [20:24] pixel bbox (r0, r1, c0, c1)
  [24:27] corner vertex ids    [27:27+3C] corner attributes (per corner:
                               corner0[0..C), corner1[0..C), corner2[0..C))
Floats encode ints exactly below 2^24.
"""

import os

import torch

from . import _cuda, geometry

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


# Clip status of a face's pixel bbox (clip_status): every corner
# at w > 0 (FRONT), or a corner at w <= 0 and the bbox the near/far clip
# gives (CLIPPED), nothing left by the clip (CULLED, the empty bbox), or the
# full screen (WHOLE: a point the clip leaves at w <= 0 or projected to a
# non-finite pixel).
FRONT, CLIPPED, CULLED, WHOLE = 0, 1, 2, 3
# The clipped path's pixel bounds are clamped to +/- _CLIP_LIMIT before
# they are converted to int32, far outside any image.
_CLIP_LIMIT = float(1 << 24)


def _clip_plane(points, live, far):
    """One Sutherland-Hodgman step: the polygons of `points` [..., n, 4]
    (x, y, z, w), their vertices the `live` [..., n] slots in slot order,
    clipped to d >= 0, d = z + w (the near plane) or w - z (`far`).
    Returns ([..., 2n, 4], [..., 2n]): slot 2s holds vertex s where it is
    live and inside, slot 2s + 1 the crossing of the edge from vertex s to
    the next live vertex, S + t (E - S) with t = d_S / (d_S - d_E), where
    it is live and that edge crosses the plane."""
    n = points.shape[-2]
    z, w = points[..., 2], points[..., 3]
    d = w - z if far else z + w
    inside = d >= 0
    slot = torch.arange(n, device=points.device)
    nxt = slot.expand(live.shape).clone()
    for k in range(n - 1, 0, -1):
        ahead = (slot + k) % n
        nxt = torch.where(live[..., ahead], ahead, nxt)
    end = torch.take_along_dim(points, nxt[..., None], dim=-2)
    d_end = torch.take_along_dim(d, nxt, dim=-1)
    t = d / (d - d_end)
    cross = points + t[..., None] * (end - points)
    crosses = live & (inside != torch.take_along_dim(inside, nxt, dim=-1))
    out = torch.stack([points, cross], dim=-2).flatten(-3, -2)
    return out, torch.stack([live & inside, crosses], dim=-1).flatten(-2)


def _clipped_bounds(corners, height, width):
    """The near/far-clipped polygon of each face's clip-space `corners`
    [..., 3, 4]: its projected pixel bounds (col0, col1, row0, row1: the
    floored least and ceiled greatest pixel coordinate, before
    pixel_bbox's slack) and its status, CULLED, WHOLE or CLIPPED."""
    live = torch.ones(corners.shape[:-1], dtype=torch.bool,
                      device=corners.device)
    points, live = _clip_plane(corners, live, far=False)
    points, live = _clip_plane(points, live, far=True)
    x, y, w = points[..., 0], points[..., 1], points[..., 3]
    px = (x / w + 1.0) * (width / 2.0)
    py = (1.0 - y / w) * (height / 2.0)
    whole = (live & ((w <= 0) | ~torch.isfinite(px)
                     | ~torch.isfinite(py))).any(dim=-1)
    culled = ~live.any(dim=-1)
    status = torch.where(culled, CULLED, torch.where(whole, WHOLE, CLIPPED))
    least = lambda p: torch.where(live, p, torch.inf).amin(dim=-1)
    most = lambda p: torch.where(live, p, -torch.inf).amax(dim=-1)
    to_int = lambda v: v.clamp(-_CLIP_LIMIT, _CLIP_LIMIT).to(torch.int32)
    return (to_int(torch.floor(least(px) - 0.5)),
            to_int(torch.ceil(most(px) - 0.5)),
            to_int(torch.floor(least(py) - 0.5)),
            to_int(torch.ceil(most(py) - 0.5)), status)


def clip_status(corners, height, width):
    """[B, F] int64: how pixel_bbox finds the bbox of each face of
    clip-space `corners` [B, F, 3, 4]: FRONT, CLIPPED, CULLED or WHOLE."""
    unbounded = (corners[..., 3] <= 0).any(dim=-1)
    return torch.where(unbounded, _clipped_bounds(corners, height, width)[-1],
                       FRONT)


def pixel_bbox(corners, valid, height, width, widen=0):
    """The conservative pixel bbox (r0, r1, c0, c1), int32 [B, F], of the
    faces' clip-space `corners` [B, F, 3, 4]: +/- 1 pixel of rounding
    slack and `widen` pixels more, clamped to the image.  Faces that are
    not `valid` get the empty bbox (_BIG, -1, _BIG, -1).

    A face with a corner at w <= 0 is clipped to -w <= z <= w (against z
    + w >= 0, then w - z >= 0, _clipped_bounds), the only part of it that
    covers a pixel: its bbox is that of the points left, projected; the
    empty bbox where none is left; the full screen where one is left at w
    <= 0 or projects to a non-finite pixel (clip_status).  Faces with
    every w > 0 keep the projection of their corners."""
    w = corners[..., 3]
    safe_w = torch.where(w > 0, w, 1.0)
    px = (corners[..., 0] / safe_w + 1.0) * (width / 2.0)
    py = (1.0 - corners[..., 1] / safe_w) * (height / 2.0)
    unbounded = (w <= 0).any(dim=-1)
    lo = lambda p: torch.floor(p.amin(dim=-1) - 0.5).to(torch.int32) - 1
    hi = lambda p: torch.ceil(p.amax(dim=-1) - 0.5).to(torch.int32) + 1
    col0, col1, row0, row1 = lo(px), hi(px), lo(py), hi(py)
    c0, c1, r0, r1, clip = _clipped_bounds(corners, height, width)
    clip = torch.where(unbounded, clip, FRONT)
    whole = clip == WHOLE
    col0 = torch.where(unbounded, c0 - 1, col0)
    col1 = torch.where(unbounded, c1 + 1, col1)
    row0 = torch.where(unbounded, r0 - 1, row0)
    row1 = torch.where(unbounded, r1 + 1, row1)
    if widen:
        col0, col1 = col0 - widen, col1 + widen
        row0, row1 = row0 - widen, row1 + widen
    col0 = torch.where(whole, 0, col0.clamp(0, width - 1))
    col1 = torch.where(whole, width - 1, col1.clamp(0, width - 1))
    row0 = torch.where(whole, 0, row0.clamp(0, height - 1))
    row1 = torch.where(whole, height - 1, row1.clamp(0, height - 1))
    keep = valid & (clip != CULLED)
    return (torch.where(keep, row0, _BIG), torch.where(keep, row1, -1),
            torch.where(keep, col0, _BIG), torch.where(keep, col1, -1))


def _face_table(vertices, vertex_colors, faces, height, width, pad_rows):
    """Per-face raster constants + corner attributes for a batch:
    [B, F + pad_rows, _BASE + 3C] float32, with the conservative pixel bbox
    (pixel_bbox) in columns 20-23 and padded rows given an empty bbox.

    Invalid (degenerate) rows get NaN z/w columns: the block schedule
    sweeps every row of a live block, and a degenerate face's rounded edge
    values can pass the fill rule; NaN s_z/s_w fail the |s_z| <= |s_w|
    test, which is what lets the sweep drop the valid-flag AND.
    """
    batch, num_faces = faces.shape[:2]
    channels = vertex_colors.shape[-1]
    device = vertices.device
    setup = geometry.face_setup(vertices, faces)
    valid = setup.valid
    row0, row1, col0, col1 = pixel_bbox(
        geometry.gather_corners(vertices, faces), valid, height, width)

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


def tile_overlap(face_data, bbox_cols, tiles_y, tiles_x, tile_h, tile_w):
    """[B, T, F] bool: the face's pixel bbox (columns `bbox_cols`, as
    (r0, r1, c0, c1)) overlaps the tile."""
    r0, r1, c0, c1 = (face_data[..., c] for c in bbox_cols)   # [B, F]
    device = face_data.device
    tile_r0 = torch.arange(tiles_y, dtype=torch.int32, device=device) * tile_h
    tile_c0 = torch.arange(tiles_x, dtype=torch.int32, device=device) * tile_w
    hit_rows = ((r0[:, None, :] <= (tile_r0 + tile_h - 1)[:, None])
                & (r1[:, None, :] >= tile_r0[:, None]))      # [B, Ty, F]
    hit_cols = ((c0[:, None, :] <= (tile_c0 + tile_w - 1)[:, None])
                & (c1[:, None, :] >= tile_c0[:, None]))      # [B, Tx, F]
    return (hit_rows[:, :, None, :] & hit_cols[:, None, :, :]).reshape(
        face_data.shape[0], tiles_y * tiles_x, -1)


def hits_first(overlap, max_rows):
    """Per tile, the stable hits-first order of the rows of `overlap`
    [B, T, F], cut to `max_rows`: (row ids [B, T, max_rows] int32, hit
    counts [B, T] int32 before the cut)."""
    order = torch.argsort((~overlap).to(torch.uint8), dim=-1, stable=True)
    counts = overlap.sum(dim=-1, dtype=torch.int32)
    return order[..., :max_rows].to(torch.int32).contiguous(), counts


def _pack_faces(vertices, vertex_colors, faces, height, width, num_chunks,
                tiles_y, tiles_x, chunk, tile_h, tile_w):
    """Exact per-tile face lists for a batch: each tile lists the rows of
    the face table whose bboxes overlap it FIRST, in draw order (a stable
    sort of ~overlap), then the rest; only the first num_chunks * chunk
    slots are kept.

    The GPU layout holds per-tile row INDICES into one face table per
    image, where dirt_tpu copies the rows themselves per tile
    ([T, NC, CHUNK, D] floats, O(T * F * D)): face_data[b, face_ids[b, t]]
    is dirt_tpu's tiled table of image b, tile t, bit for bit.  The
    table is forward_blocks.face_table's in face order (K13's rows on
    CUDA, _face_table on the CPU).

    Returns:
        face_data: [B, F', _BASE + 3C] float32, F' = max(num_chunks *
            chunk, F) (padded rows never hit).
        face_ids: [B, T, num_chunks * chunk] int32 rows of face_data.
        counts: [B, T] int32 hit count per tile, cut to the slots.
        dropped: [B] int32 hits beyond the slots, summed over tiles
            (0 when the packing is exact; see RasterAux.dropped).
    """
    from . import forward_blocks
    num_faces = faces.shape[1]
    max_rows = num_chunks * chunk
    pad_rows = max(max_rows, num_faces) - num_faces
    face_data, _ = forward_blocks.face_table(
        vertices, faces, vertex_colors, height, width, num_faces + pad_rows)
    overlap = tile_overlap(face_data, (20, 21, 22, 23), tiles_y, tiles_x,
                           tile_h, tile_w)
    face_ids, counts = hits_first(overlap, max_rows)
    dropped = (counts - max_rows).clamp(min=0).sum(dim=-1, dtype=torch.int32)
    return face_data, face_ids, counts.clamp(max=max_rows), dropped


def tile_face_cap(num_faces):
    """Face slots per tile of the dense packings: all faces up to
    DIRT_TPU_TORCH_TILE_FACE_CAP (default 8192; <= 0 means no cap).  A
    tile overlapped by more faces keeps the earliest-drawn `cap` of them
    and counts the rest in RasterAux.dropped."""
    cap = int(os.environ.get("DIRT_TPU_TORCH_TILE_FACE_CAP", "8192"))
    if cap <= 0:
        return num_faces
    return min(num_faces, cap)


# --------------------------------------------------------------------------
# K8: the "pallas" backend's two-phase kernel
# --------------------------------------------------------------------------

PALLAS_RASTER = _cuda.Kernel(
    "pallas_raster", "dirt_pallas_raster",
    [_cuda.ptr] * 9 + [_cuda.i32] * 10 + [_cuda.f32] * 2 + [_cuda.i32] * 6
    + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_pallas.py:215",
    source="pallas_raster.cu")


def _cdiv(a, b):
    return -(-a // b)


def _visibility_plain(face_table, face_ids, counts, height, width, tiles_x,
                      num_tiles, tile_h, tile_w, chunk):
    """Phase 1 of dirt_tpu's _raster_kernel for R tile runs: each pixel's
    winner among its tile's counts[r] listed rows, by the literal coverage
    tree (both sign branches, the valid flag) and the lexicographic
    (depth, original index) z-test from glClearDepth's (1.0, -1).

    Returns (winner table row [R, PIX] int64, -1 for none; its depth
    [R, PIX])."""
    from . import forward_dense
    runs = counts.shape[0]
    device = counts.device
    pix = tile_h * tile_w
    best_row = torch.full((runs, pix), -1, dtype=torch.long, device=device)
    best_depth = torch.ones(runs, pix, device=device)
    step = max(1, forward_dense._PLAIN_ELEMENTS // (chunk * pix))
    for r0 in range(0, runs, step):
        r1 = min(runs, r0 + step)
        tile = torch.arange(r0, r1, device=device) % num_tiles
        xg, yg = forward_dense.pixel_ndc((tile // tiles_x) * tile_h,
                                         (tile % tiles_x) * tile_w,
                                         height, width, tile_h, tile_w)
        n = counts[r0:r1]
        depth_b = torch.ones(r1 - r0, 1, pix, device=device)
        orig_b = torch.full((r1 - r0, 1, pix), -1.0, device=device)
        row_b = torch.full((r1 - r0, 1, pix), -1, dtype=torch.long,
                           device=device)
        for m in range(_cdiv(int(n.max()), chunk)):
            ids = face_ids[r0:r1, m * chunk:(m + 1) * chunk].long()  # [R, K]
            slot = m * chunk + torch.arange(ids.shape[1], device=device)
            live = (slot < n[:, None])[..., None]                    # [R,K,1]
            rows = face_table[ids]                                   # [R,K,D]
            col = lambda i: rows[:, :, i:i + 1]
            E0 = (col(0) * xg + col(1) * yg) + col(2)
            E1 = (col(3) * xg + col(4) * yg) + col(5)
            E2 = (col(6) * xg + col(7) * yg) + col(8)
            s_z = (E0 * col(9) + E1 * col(10)) + E2 * col(11)
            s_w = (E0 * col(12) + E1 * col(13)) + E2 * col(14)
            a0, a1, a2 = (col(15 + k) != 0.0 for k in range(3))
            in_p = (((E0 > 0) | ((E0 == 0) & a0))
                    & ((E1 > 0) | ((E1 == 0) & a1))
                    & ((E2 > 0) | ((E2 == 0) & a2)))
            in_n = (((E0 < 0) | ((E0 == 0) & ~a0))
                    & ((E1 < 0) | ((E1 == 0) & ~a1))
                    & ((E2 < 0) | ((E2 == 0) & ~a2)))
            cov_p = in_p & (s_w > 0) & (s_z >= -s_w) & (s_z <= s_w)
            cov_n = in_n & (s_w < 0) & (s_z <= -s_w) & (s_z >= s_w)
            covered = (cov_p | cov_n) & (col(18) != 0.0) & live
            depth = torch.where(covered, s_z / s_w, torch.inf)
            # The chunk's lexicographic minimum, then GL_LESS + draw-order
            # ties against the running winner (associative: the same winner
            # as dirt_tpu's face-by-face loop).
            orig = col(19)
            chunk_depth = depth.amin(dim=1, keepdim=True)
            at_best = covered & (depth == chunk_depth)
            chunk_orig = torch.where(at_best, orig, float(_BIG)).amin(
                dim=1, keepdim=True)
            chunk_row = torch.where(at_best & (orig == chunk_orig),
                                    ids[..., None], -1).amax(dim=1,
                                                             keepdim=True)
            better = (chunk_depth < torch.inf) & (
                (chunk_depth < depth_b)
                | ((chunk_depth == depth_b) & (chunk_orig < orig_b)))
            depth_b = torch.where(better, chunk_depth, depth_b)
            orig_b = torch.where(better, chunk_orig, orig_b)
            row_b = torch.where(better, chunk_row, row_b)
        best_row[r0:r1] = row_b[:, 0]
        best_depth[r0:r1] = depth_b[:, 0]
    return best_row, best_depth


def pallas_raster_plain(face_table, face_ids, counts, background, tiles_x,
                        num_tiles, tile_h, tile_w, chunk):
    """dirt_tpu's _raster_kernel for a batch: phase 1 (_visibility_plain),
    then phase 2 shades each pixel's winner from its table row with
    forward_dense.finalize's expressions (the interpolation numerators,
    one division by (E0 + E1) + E2, the background and aux clears).

    Returns (pixels [B, H, W, C], face_index [B, H, W] int32, indices
    [B, H, W, 3] int32, barycentric [B, H, W, 3], clip_w [B, H, W])."""
    from . import forward_dense
    batch, height, width, channels = background.shape
    tiles_y = num_tiles // tiles_x
    best_row, best_depth = _visibility_plain(
        face_table, face_ids, counts, height, width, tiles_x, num_tiles,
        tile_h, tile_w, chunk)
    tile = torch.arange(counts.shape[0], device=counts.device) % num_tiles
    xg, yg = forward_dense.pixel_ndc((tile // tiles_x) * tile_h,
                                     (tile % tiles_x) * tile_w, height, width,
                                     tile_h, tile_w)
    xg, yg = xg[:, 0], yg[:, 0]                                  # [R, PIX]
    f = face_table[best_row.clamp(min=0)]                        # [R, PIX, D]
    col = lambda i: f[..., i]
    E0 = (col(0) * xg + col(1) * yg) + col(2)
    E1 = (col(3) * xg + col(4) * yg) + col(5)
    E2 = (col(6) * xg + col(7) * yg) + col(8)
    s_w = (E0 * col(12) + E1 * col(13)) + E2 * col(14)
    nums = [(E0 * col(_BASE + ch) + E1 * col(_BASE + channels + ch))
            + E2 * col(_BASE + 2 * channels + ch) for ch in range(channels)]
    covered = best_row >= 0
    orig = torch.where(covered, col(19), -1.0)
    # forward_dense's packed state [R, C+9, PIX], for finalize.
    state = torch.stack(nums + [E0, E1, E2, s_w, col(24), col(25), col(26),
                                best_depth, orig], dim=1)
    pixels, aux = forward_dense.finalize(
        state.reshape(batch, num_tiles, channels + 9, tile_h * tile_w),
        background, height, width, tiles_y, tiles_x, tile_h=tile_h,
        tile_w=tile_w)
    return (pixels, aux.face_index, aux.indices, aux.barycentric,
            aux.clip_w)


def pallas_raster(face_table, face_ids, counts, background, tiles_x,
                  num_tiles, tile_h, tile_w, chunk):
    """K8 wrapper: pallas_raster_plain's outputs, by the CUDA kernel for
    CUDA tensors and by the plain version for CPU tensors.

    face_table [B*F', D] f32 (the images' tables stacked); face_ids
    [B*T, slots] int32 rows of it, batch-folded; counts [B*T] int32;
    background [B, H, W, C] f32.  The kernel walks each list with K1's
    run walk at one face a visit (forward_blocks.sweep_shape(pix, 1, ..));
    `chunk` is the plain version's."""
    from . import forward_blocks
    if not _cuda.on_cuda(face_table, face_ids, counts, background):
        return pallas_raster_plain(face_table, face_ids, counts, background,
                                   tiles_x, num_tiles, tile_h, tile_w, chunk)
    batch, height, width, channels = background.shape
    runs, slots = face_ids.shape
    if tile_h * tile_w > 1024:
        raise ValueError(f"pallas_raster runs one thread per pixel: a "
                         f"{tile_h}x{tile_w} tile exceeds 1024 threads")
    if runs != batch * num_tiles:
        raise ValueError(f"{runs} face lists for {batch} images of "
                         f"{num_tiles} tiles")
    shape = forward_blocks._sweep_args(face_table[:, None], tile_h * tile_w)
    device = background.device
    hw = (batch, height, width)
    pixels = torch.empty(hw + (channels,), device=device)
    face_index = torch.empty(hw, dtype=torch.int32, device=device)
    indices = torch.empty(hw + (3,), dtype=torch.int32, device=device)
    barycentric = torch.empty(hw + (3,), device=device)
    clip_w = torch.empty(hw, device=device)
    PALLAS_RASTER(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("face_ids", face_ids, torch.int32),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("background", background, torch.float32),
        _cuda.check("pixels", pixels, torch.float32),
        _cuda.check("face_index", face_index, torch.int32),
        _cuda.check("indices", indices, torch.int32),
        _cuda.check("barycentric", barycentric, torch.float32),
        _cuda.check("clip_w", clip_w, torch.float32),
        runs, slots, num_tiles, tiles_x, tile_h, tile_w,
        face_table.shape[1], channels, height, width, 2.0 / width,
        2.0 / height, *shape, _cuda.stream())
    return pixels, face_index, indices, barycentric, clip_w


def rasterise_batch(background, vertices, vertex_colors, faces, tile_h=None,
                    tile_w=None, chunk=None):
    """Batched forward rasterisation through the "pallas" backend.

    Returns (pixels [B, H, W, C], reference.RasterAux) with `dropped`, the
    per-image hits beyond the per-tile cap (tile_face_cap).  The packing is
    the dense backend's (forward_dense.pack, its tile and chunk by
    default), so the outputs equal its outputs bit for bit."""
    from . import forward_dense, reference
    batch, height, width, _ = background.shape
    if faces.shape[1] == 0:
        return reference.rasterise_batch(background, vertices, vertex_colors,
                                         faces)
    if tile_h is None or tile_w is None:
        tile_h, tile_w = forward_dense.tile_shape(height, width)
    chunk = chunk or forward_dense.CHUNK
    tiles_x = _cdiv(width, tile_w)
    num_tiles = _cdiv(height, tile_h) * tiles_x
    face_table, face_ids, counts, dropped = forward_dense.pack(
        vertices, vertex_colors, faces, height, width, tile_h, tile_w, chunk)
    pixels, face_index, indices, barycentric, clip_w = pallas_raster(
        face_table, face_ids, counts, background, tiles_x, num_tiles, tile_h,
        tile_w, chunk)
    return pixels, reference.RasterAux(face_index, indices, barycentric,
                                       clip_w, dropped)
