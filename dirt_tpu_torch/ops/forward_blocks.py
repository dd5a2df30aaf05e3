"""Block-binned (CSR) forward rasteriser: the CUDA main path (PyTorch port
of dirt_tpu/ops/forward_blocks.py).

The schedule is the JAX package's fused-CSR one:

  * faces are grouped into BLOCKS of `chunk` rows of the face table
    (ops/forward_pallas.py layout), after a Morton sort of the rows by
    their bbox-centre tile (spatial_order) so blocks are spatially
    coherent whatever the draw order;
  * the hit test (hit_matrix, kernel K4 on CUDA) keeps a (tile, block)
    pair when some member face's bbox overlaps the tile and its
    edge-sign regions can reach it (the conservative half-plane cull);
  * build_runs lays the hits out as CSR runs: per tile, the live block
    ids in ascending order, under a static slot budget whose overflow is
    counted in RasterAux.dropped;
  * the sweep (raster_sweep, kernel K1 on CUDA) walks each tile's run and
    keeps the lexicographic (depth, original index) winner per pixel;
  * forward_dense.finalize does the one division and the aux assembly.

Tile shape and block size are parameters.  The defaults are this port's
GPU shape (16x16-pixel tiles, one thread per pixel; 32-face blocks); the
tests call the functions at the JAX package's shapes (4x128 tiles,
64-face blocks) to compare with it bitwise.
"""

import os

import torch

from . import _cuda, forward_dense, forward_pallas, reference

TILE_H = 16
TILE_W = 16
CHUNK = 32
_BBOX = (20, 21, 22, 23)


def _cdiv(a, b):
    return -(-a // b)


def slots_per_image(num_runs, num_items):
    """Static slot-list length per image for a CSR sweep of `num_runs`
    runs over `num_items` candidates: ~8x max(runs, items) of overlap
    slack (DIRT_TPU_TORCH_SLOTS_PER_IMAGE overrides it)."""
    env = int(os.environ.get("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", "0"))
    if env > 0:
        return min(num_runs * num_items, env)
    return min(num_runs * num_items,
               max(512, num_runs + 8 * max(num_runs, num_items)))


def _morton(y, x):
    """Interleaves the low 16 bits of two non-negative int32 coordinate
    tensors (y gets the odd bits) -- the Z-order curve key."""
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return (spread(y) << 1) | spread(x)


def spatial_order(face_data, bbox_cols, tile_h, tile_w):
    """[B, F] stable permutation of the table rows by the Morton code of
    each face's bbox-centre tile; empty bboxes sort last, ties keep draw
    order."""
    r0, r1, c0, c1 = (face_data[..., c].to(torch.int32) for c in bbox_cols)
    empty = r1 < r0
    ty = ((r0 + r1) // 2).clamp(min=0) // tile_h
    tx = ((c0 + c1) // 2).clamp(min=0) // tile_w
    key = _morton(ty.clamp(0, (1 << 15) - 1), tx.clamp(0, (1 << 15) - 1))
    key = torch.where(empty, torch.iinfo(torch.int32).max, key)
    return torch.argsort(key, dim=-1, stable=True).to(torch.int32)


def build_runs(hit, num_slots):
    """CSR schedule from the [B, R, I] bool hit matrix: (starts [B, R],
    counts [B, R], item_ids [B, S], dropped [B]) int32, per image.  Run
    r's live items (ascending) occupy item_ids[starts[r]:starts[r] +
    counts[r]]; truncation by the static budget clamps the last runs and
    is counted in `dropped`."""
    batch, num_runs, num_items = hit.shape
    n = hit.sum(dim=-1, dtype=torch.int32)                   # [B, R]
    total = n.cumsum(dim=-1, dtype=torch.int32)
    starts = (total - n).clamp(max=num_slots)
    counts = total.clamp(max=num_slots) - starts
    j = torch.arange(num_items, dtype=torch.int32, device=hit.device)
    order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
    pos = torch.where(j < n[..., None], starts[..., None] + j, num_slots)
    pos = pos.clamp(max=num_slots).reshape(batch, -1).long()
    item_ids = torch.zeros(batch, num_slots + 1, dtype=torch.int32,
                           device=hit.device)
    item_ids.scatter_(1, pos, order.reshape(batch, -1).to(torch.int32))
    dropped = (n.sum(dim=-1, dtype=torch.int32) - num_slots).clamp(min=0)
    return starts, counts, item_ids[:, :num_slots].contiguous(), dropped


# --------------------------------------------------------------------------
# K4: the hit plane
# --------------------------------------------------------------------------

HIT_PLANE = _cuda.Kernel(
    "hit_plane", "dirt_hit_plane",
    [_cuda.ptr, _cuda.ptr] + [_cuda.i32] * 13 + [_cuda.f32] * 2
    + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:322")


def _edge_keep(row, edge_cols, tile_r0, tile_c0, tile_h, tile_w, height,
               width, dilate):
    """[B, T, F] bool: the face's edge-sign regions can reach the tile.

    Coverage needs all three edge functions >= 0 or all <= 0 at a pixel
    centre; E_i is linear in NDC, so its extremes over the tile's
    pixel-centre rectangle (grown by `dilate` pixels) sit at corners.  A
    tile is culled iff some edge is below -margin everywhere and some edge
    above +margin everywhere; the 8-ulp margin on |a| + |b| + |c| absorbs
    the rounding of this corner test and of the per-pixel evaluation, so
    the cull is conservative.  `row(i)` is table column i as [B, 1, F];
    tile_r0/tile_c0 are the tiles' first pixel row/column, [T, 1] f32.
    """
    c_lo = tile_c0 - dilate
    c_hi = (c_lo + (tile_w - 1)) + 2 * dilate
    r_lo = tile_r0 - dilate
    r_hi = (r_lo + (tile_h - 1)) + 2 * dilate
    x_lo = (c_lo + 0.5) * (2.0 / width) - 1.0
    x_hi = (c_hi + 0.5) * (2.0 / width) - 1.0
    y_hi = 1.0 - (r_lo + 0.5) * (2.0 / height)
    y_lo = 1.0 - (r_hi + 0.5) * (2.0 / height)
    any_max_neg = any_min_pos = None
    for i in range(3):
        a = row(edge_cols + 3 * i)
        b = row(edge_cols + 3 * i + 1)
        c = row(edge_cols + 3 * i + 2)
        margin = ((a.abs() + b.abs()) + c.abs()) * (2.0 ** -20)
        a_pos, b_pos = a > 0, b > 0
        ax_max = a * torch.where(a_pos, x_hi, x_lo)
        ax_min = a * torch.where(a_pos, x_lo, x_hi)
        by_max = b * torch.where(b_pos, y_hi, y_lo)
        by_min = b * torch.where(b_pos, y_lo, y_hi)
        mx = (by_max + (ax_max + c)) < -margin
        mn = (by_min + (ax_min + c)) > margin
        any_max_neg = mx if any_max_neg is None else any_max_neg | mx
        any_min_pos = mn if any_min_pos is None else any_min_pos | mn
    return ~(any_max_neg & any_min_pos)


def hit_plane_plain(face_data, bbox_cols, tiles_y, tiles_x, tile_h, tile_w,
                    edge_cols, height, width, dilate):
    """[B, T, F] float32 keep plane (1.0 keep): bbox overlap, refined by the
    conservative half-plane cull (_edge_keep) when `edge_cols` is given.
    The expression tree of dirt_tpu's _hit_kernel, term for term."""
    t = torch.arange(tiles_y * tiles_x, dtype=torch.int32,
                     device=face_data.device)
    tile_r0 = ((t // tiles_x) * tile_h).float()[:, None]   # [T, 1]
    tile_c0 = ((t % tiles_x) * tile_w).float()[:, None]
    row = lambda i: face_data[:, None, :, i]               # [B, 1, F]
    r0c, r1c, c0c, c1c = bbox_cols
    keep = ((row(r0c) <= tile_r0 + (tile_h - 1))
            & (row(r1c) >= tile_r0)
            & (row(c0c) <= tile_c0 + (tile_w - 1))
            & (row(c1c) >= tile_c0))                       # [B, T, F]
    if edge_cols is not None:
        keep = keep & _edge_keep(row, edge_cols, tile_r0, tile_c0, tile_h,
                                 tile_w, height, width, dilate)
    return keep.float()


def hit_plane(face_data, bbox_cols, tiles_y, tiles_x, tile_h, tile_w,
              edge_cols, height, width, dilate):
    """K4 wrapper: the [B, T, F] keep plane of hit_plane_plain, by the CUDA
    kernel for CUDA tensors and by the plain version for CPU tensors."""
    if not _cuda.on_cuda(face_data):
        return hit_plane_plain(face_data, bbox_cols, tiles_y, tiles_x,
                               tile_h, tile_w, edge_cols, height, width,
                               dilate)
    batch, num_faces, width_d = face_data.shape
    num_tiles = tiles_y * tiles_x
    keep = torch.empty(batch, num_tiles, num_faces, device=face_data.device)
    HIT_PLANE(
        _cuda.check("face_data", face_data, torch.float32),
        _cuda.check("keep", keep, torch.float32),
        batch, num_faces, width_d, num_tiles, tiles_x, tile_h, tile_w,
        *bbox_cols, -1 if edge_cols is None else edge_cols, dilate,
        2.0 / width, 2.0 / height, _cuda.stream())
    return keep


def hit_matrix(face_data, bbox_cols, num_blocks, chunk,
               tiles_y, tiles_x, tile_h, tile_w,
               edge_cols=None, height=None, width=None, dilate=0):
    """[B, T, NB] bool: block hits tile iff some member face is kept by the
    hit plane (bbox overlap, plus the half-plane cull with `edge_cols`,
    the column of the first of 9 consecutive edge coefficients)."""
    keep = hit_plane(face_data, bbox_cols, tiles_y, tiles_x, tile_h, tile_w,
                     edge_cols, height, width, dilate)
    batch = face_data.shape[0]
    return (keep > 0.5).reshape(batch, tiles_y * tiles_x, num_blocks,
                                chunk).any(dim=-1)


# --------------------------------------------------------------------------
# K1: the sweep
# --------------------------------------------------------------------------

RASTER_SWEEP = _cuda.Kernel(
    "raster_sweep", "dirt_raster_sweep",
    [_cuda.ptr] * 5 + [_cuda.i32] * 8 + [_cuda.f32] * 2 + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:576")

# Plain sweep: tiles per vectorised step, bounding the [tiles, chunk, PIX]
# planes at ~2^25 elements.
_PLAIN_ELEMENTS = 1 << 25


def raster_sweep_plain(face_table, starts, counts, block_ids, channels,
                       height, width, tiles_x, num_tiles, tile_h, tile_w):
    """Per-pixel state [B*T, C+9, PIX] of the CSR sweep: tile bt sweeps
    the face blocks block_ids[starts[bt] : starts[bt] + counts[bt]] in
    order through forward_dense._chunk_candidates / merge_state.  All
    tiles advance one visit per step (visit m of every tile whose run is
    that long), which keeps each tile's merge order."""
    device = face_table.device
    chunk, width_d = face_table.shape[1], face_table.shape[2]
    pix = tile_h * tile_w
    ns = channels + 9
    runs = starts.shape[0]
    state = forward_dense.init_state(channels, pix, (runs,), device)
    step = max(1, _PLAIN_ELEMENTS // (chunk * pix))
    for r0 in range(0, runs, step):
        r1 = min(runs, r0 + step)
        tile = torch.arange(r0, r1, device=device) % num_tiles
        xg, yg = forward_dense.pixel_ndc(
            (tile // tiles_x) * tile_h, (tile % tiles_x) * tile_w,
            height, width, tile_h, tile_w)                 # [R, 1, PIX]
        st, n = starts[r0:r1].long(), counts[r0:r1]
        part = state[r0:r1]
        for m in range(int(n.max())):
            live = m < n
            bid = block_ids[(st + m).clamp(max=block_ids.shape[0] - 1)]
            rows = face_table[bid.long()]                  # [R, K, D]
            col = lambda i: rows[:, :, i:i + 1]
            cand, bd, bo = forward_dense._chunk_candidates(
                col, xg, yg, channels)
            merged = forward_dense.merge_state(part, cand, bd, bo, ns)
            part = torch.where(live[:, None, None], merged, part)
        state[r0:r1] = part
    return state


def raster_sweep(face_table, starts, counts, block_ids, channels,
                 height, width, tiles_x, num_tiles, tile_h, tile_w):
    """K1 wrapper: raster_sweep_plain's state, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    face_table [B*NB, chunk, D] f32; starts, counts [B*T] and block_ids
    [B*S] int32, batch-folded (ids index the flat table)."""
    if not _cuda.on_cuda(face_table, starts, counts, block_ids):
        return raster_sweep_plain(face_table, starts, counts, block_ids,
                                  channels, height, width, tiles_x,
                                  num_tiles, tile_h, tile_w)
    runs = starts.shape[0]
    chunk, width_d = face_table.shape[1], face_table.shape[2]
    pix = tile_h * tile_w
    if pix > 1024:
        raise ValueError(f"raster_sweep runs one thread per pixel: a "
                         f"{tile_h}x{tile_w} tile exceeds 1024 threads")
    state = torch.empty(runs, channels + 9, pix, device=face_table.device)
    RASTER_SWEEP(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("starts", starts, torch.int32, (runs,)),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("block_ids", block_ids, torch.int32),
        _cuda.check("state", state, torch.float32),
        runs, num_tiles, tiles_x, tile_h, tile_w, chunk, width_d, channels,
        2.0 / width, 2.0 / height, _cuda.stream())
    return state


def pack(vertices, vertex_colors, faces, height, width, tile_h, tile_w,
         chunk):
    """The forward schedule for a batch: (face_table [B*NB, chunk, D],
    starts [B*T], counts [B*T], block_ids [B*S], dropped [B]), with the
    CSR ids folded over the batch."""
    batch, num_faces = faces.shape[:2]
    num_blocks = _cdiv(num_faces, chunk)
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_tiles = tiles_y * tiles_x
    num_slots = slots_per_image(num_tiles, num_blocks)

    face_data = forward_pallas._face_table(
        vertices, vertex_colors, faces, height, width,
        num_blocks * chunk - num_faces)
    order = spatial_order(face_data, _BBOX, tile_h, tile_w)
    face_data = torch.take_along_dim(face_data, order[..., None].long(),
                                     dim=1).contiguous()
    hit = hit_matrix(face_data, _BBOX, num_blocks, chunk, tiles_y, tiles_x,
                     tile_h, tile_w, edge_cols=0, height=height, width=width)
    starts, counts, block_ids, dropped = build_runs(hit, num_slots)
    boff = torch.arange(batch, dtype=torch.int32, device=faces.device)[:, None]
    return (face_data.reshape(batch * num_blocks, chunk, -1),
            (starts + num_slots * boff).reshape(-1),
            counts.reshape(-1),
            (block_ids + num_blocks * boff).reshape(-1),
            dropped)


def rasterise_batch(background, vertices, vertex_colors, faces,
                    tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK):
    """Batched forward rasterisation through the block-binned schedule.

    Returns (pixels [B, H, W, C], reference.RasterAux); visibility matches
    the reference backend bit-exactly on tie-free scenes (the same
    per-fragment expressions; only which faces a tile sweeps differs, and
    unswept faces cannot cover its pixels).
    """
    batch, height, width, channels = background.shape
    if faces.shape[1] == 0:
        return reference.rasterise_batch(background, vertices, vertex_colors,
                                         faces)
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_tiles = tiles_y * tiles_x
    face_table, starts, counts, block_ids, dropped = pack(
        vertices, vertex_colors, faces, height, width, tile_h, tile_w, chunk)
    state = raster_sweep(face_table, starts, counts, block_ids, channels,
                         height, width, tiles_x, num_tiles, tile_h, tile_w)
    state = state.reshape(batch, num_tiles, channels + 9, tile_h * tile_w)
    pixels, aux = forward_dense.finalize(state, background, height, width,
                                         tiles_y, tiles_x,
                                         tile_h=tile_h, tile_w=tile_w)
    return pixels, aux._replace(dropped=dropped)
