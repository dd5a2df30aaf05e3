"""The "dense" forward backend and the sweep math every forward shares
(PyTorch port of dirt_tpu/ops/forward_dense.py).

  * forward_pallas._pack_faces gives each tile its exact face list: the
    faces whose bboxes overlap it, first, in draw order, under the
    per-tile cap (forward_pallas.tile_face_cap) whose overflow is counted
    in RasterAux.dropped;
  * the sweep (dense_sweep, kernel K7 on CUDA, on K1's run walk) walks
    each tile's list and keeps the lexicographic (depth, original index)
    winner per pixel: dirt_tpu's _chunk_candidates + merge_state over the
    list's live chunks;
  * finalize un-tiles the state and does the one division (shared with
    the block-binned backend, ops/forward_blocks.py, whose sweep K1 runs
    the same per-face arithmetic).

Tile shape and chunk are parameters.  The default tile is this port's GPU
shape (16x16 pixels, one thread per pixel); the tests call the backend at
dirt_tpu's shapes (16x256, or 32x128 when the image is at most 128 wide)
to compare with it.

Packed per-pixel state rows (all float32; ints are exact below 2^24):
  [0:C]  interpolation numerators      [C:C+3]  E0, E1, E2 of the winner
  [C+3]  S_w of the winner             [C+4:C+7] winner vertex ids
  [C+7]  depth (running z-buffer)      [C+8]    original face index (-1 bg)
"""

import torch

from . import _cuda, forward_pallas, reference

_BASE = forward_pallas._BASE
TILE_H = 16
TILE_W = 16
CHUNK = 64
# Plain sweeps: tiles per vectorised step, bounding the [tiles, chunk, PIX]
# planes at ~2^25 elements.
_PLAIN_ELEMENTS = 1 << 25


def _cdiv(a, b):
    return -(-a // b)


def tile_shape(height, width):
    """The dense backend's GPU tile: 16x16 pixels, one thread per pixel of
    kernel K7 at any image size.  (dirt_tpu's TPU shapes are 16x256, or
    32x128 for images at most 128 wide; rasterise_batch takes them as
    parameters.)"""
    del height, width
    return TILE_H, TILE_W


def pixel_ndc(tile_row, tile_col, height, width, tile_h, tile_w):
    """Pixel-centre NDC rows of flattened tiles, the expression of
    geometry.pixel_centre_ndc.  tile_row/tile_col are int tensors [...]
    (first pixel row/column of each tile); returns (xg, yg) [..., 1, PIX]."""
    p = torch.arange(tile_h * tile_w, dtype=torch.int32,
                     device=tile_row.device)
    rows = p // tile_w
    cols = p - rows * tile_w
    xg = ((tile_col[..., None] + cols).float() + 0.5) * (2.0 / width) - 1.0
    yg = 1.0 - ((tile_row[..., None] + rows).float() + 0.5) * (2.0 / height)
    return xg[..., None, :], yg[..., None, :]


def init_state(channels, pix, lead=(), device=None):
    """glClearDepth(1.0) equivalent: [*lead, C+9, PIX] with depth 1.0 and
    orig -1 (background); value rows are zero until a face wins."""
    state = torch.zeros(*lead, channels + 9, pix, device=device)
    state[..., channels + 7, :] = 1.0
    state[..., channels + 8, :] = -1.0
    return state


def _chunk_candidates(col, xg, yg, channels):
    """One dense chunk sweep in the COVER_FAST coverage form.

    `col(i)` returns face-table column i as [..., K, 1]; xg/yg are
    [..., 1, PIX].  Returns (cand [..., C+9, PIX], best_depth [..., 1, PIX],
    best_orig [..., 1, PIX]).  `covered` is bitwise the spec tree of
    geometry.fragment_cover_depth AND-ed with the valid flag (see the JAX
    module: the sign-branch union folds into per-edge equality with
    sp = s_w > 0, the clip becomes |s_z| <= |s_w|, and invalid rows die on
    their NaN z/w columns).
    """
    E0 = (col(0) * xg + col(1) * yg) + col(2)
    E1 = (col(3) * xg + col(4) * yg) + col(5)
    E2 = (col(6) * xg + col(7) * yg) + col(8)

    s_z = (E0 * col(9) + E1 * col(10)) + E2 * col(11)
    s_w = (E0 * col(12) + E1 * col(13)) + E2 * col(14)
    a0 = col(15) != 0.0
    a1 = col(16) != 0.0
    a2 = col(17) != 0.0
    sp = s_w > 0.0
    d0 = ((E0 > 0) | ((E0 == 0) & a0)) == sp
    d1 = ((E1 > 0) | ((E1 == 0) & a1)) == sp
    d2 = ((E2 > 0) | ((E2 == 0) & a2)) == sp
    covered = (d0 & d1 & d2) & (s_w != 0.0) & (s_z.abs() <= s_w.abs())
    depth = torch.where(covered, s_z / s_w, torch.inf)

    orig_col = col(19)
    best_depth = depth.amin(dim=-2, keepdim=True)
    at_best = depth == best_depth
    best_orig = torch.where(at_best, orig_col, float(forward_pallas._BIG)
                            ).amin(dim=-2, keepdim=True)
    winner = at_best & (orig_col == best_orig)

    def pick(plane):
        return torch.where(winner, plane, 0.0).sum(dim=-2, keepdim=True)

    # Numerators ((E0*a0 + E1*a1) + E2*a2): the expression of
    # geometry.interpolate_attributes, so constants stay exact.
    rows = [pick((E0 * col(_BASE + ch) + E1 * col(_BASE + channels + ch))
                 + E2 * col(_BASE + 2 * channels + ch))
            for ch in range(channels)]
    rows += [pick(E0), pick(E1), pick(E2), pick(s_w)]
    rows += [pick(col(24 + k)) for k in range(3)]
    rows += [best_depth, best_orig]
    return torch.cat(rows, dim=-2), best_depth, best_orig


def merge_state(prev, cand, best_depth, best_orig, ns):
    """GL_LESS + draw-order-tie merge of a chunk's winner into the running
    per-pixel state [..., NS, PIX]."""
    chunk_cov = best_depth < torch.inf
    prev_depth = prev[..., ns - 2:ns - 1, :]
    prev_orig = prev[..., ns - 1:ns, :]
    better = chunk_cov & (
        (best_depth < prev_depth)
        | ((best_depth == prev_depth) & (best_orig < prev_orig)))
    return torch.where(better, cand, prev)


def finalize(state, background, height, width, tiles_y, tiles_x,
             *, tile_h, tile_w):
    """Un-tiles the packed state [B, T, NS, PIX] and runs the postprocess:
    one division, composite, aux assembly.  Tiles past the image edge are
    cropped."""
    batch, _, _, channels = background.shape
    ns = channels + 9
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    state = state.reshape(batch, tiles_y, tiles_x, ns, tile_h, tile_w)
    state = state.permute(0, 1, 4, 2, 5, 3).reshape(batch, hp, wp, ns)
    state = state[:, :height, :width]

    num = state[..., :channels]
    e01 = state[..., channels:channels + 3]
    sw = state[..., channels + 3]
    vid = state[..., channels + 4:channels + 7]
    orig = state[..., channels + 8].to(torch.int32)

    covered = orig >= 0
    den = (e01[..., 0] + e01[..., 1]) + e01[..., 2]
    safe_den = torch.where(den == 0, 1.0, den)
    pixels = torch.where(covered[..., None], num / safe_den[..., None],
                         background)
    bary = torch.where(covered[..., None], e01 / safe_den[..., None], -1.0)
    clip_w = torch.where(covered, sw / safe_den, torch.inf)
    indices = torch.where(covered[..., None], vid.to(torch.int32), -1)
    aux = reference.RasterAux(face_index=orig, indices=indices,
                              barycentric=bary, clip_w=clip_w)
    return pixels, aux


# --------------------------------------------------------------------------
# K7: the sweep over per-tile face lists
# --------------------------------------------------------------------------

DENSE_SWEEP = _cuda.Kernel(
    "dense_sweep", "dirt_dense_sweep",
    [_cuda.ptr] * 4 + [_cuda.i32] * 10 + [_cuda.f32] * 2 + [_cuda.i32] * 6
    + [_cuda.ptr],
    replaces=("dirt_tpu/ops/forward_dense.py:290, "
              "dirt_tpu/ops/forward_dense.py:262"),
    source="dense_sweep.cu")


def sweep_plain(visit_rows, visits, channels, height, width, tiles_x,
                num_tiles, tile_h, tile_w, chunk):
    """Per-pixel state [R, C+9, PIX] of R tile runs, each sweeping
    visits[r] chunks of face-table rows through _chunk_candidates and
    merge_state, in order.  visit_rows(r0, r1, m) gives visit m of runs
    r0..r1-1 as [r1 - r0, chunk, D].  All runs advance one visit per step
    (visit m of every run that long), which keeps each run's merge
    order."""
    runs = visits.shape[0]
    device = visits.device
    ns = channels + 9
    state = init_state(channels, tile_h * tile_w, (runs,), device)
    step = max(1, _PLAIN_ELEMENTS // (chunk * tile_h * tile_w))
    for r0 in range(0, runs, step):
        r1 = min(runs, r0 + step)
        tile = torch.arange(r0, r1, device=device) % num_tiles
        xg, yg = pixel_ndc((tile // tiles_x) * tile_h,
                           (tile % tiles_x) * tile_w,
                           height, width, tile_h, tile_w)   # [R, 1, PIX]
        n = visits[r0:r1]
        part = state[r0:r1]
        for m in range(int(n.max())):
            rows = visit_rows(r0, r1, m)                    # [R, K, D]
            col = lambda i: rows[:, :, i:i + 1]
            cand, bd, bo = _chunk_candidates(col, xg, yg, channels)
            merged = merge_state(part, cand, bd, bo, ns)
            part = torch.where((m < n)[:, None, None], merged, part)
        state[r0:r1] = part
    return state


def dense_sweep_plain(face_table, face_ids, counts, channels, height, width,
                      tiles_x, num_tiles, tile_h, tile_w, chunk):
    """Per-pixel state [B*T, C+9, PIX]: tile run bt sweeps the live chunks
    (ceil(counts[bt] / chunk)) of its face list face_ids[bt], as
    dirt_tpu's fused dense kernel does; a live chunk's tail slots hold
    faces that miss the tile and cover nothing."""
    def visit_rows(r0, r1, m):
        ids = face_ids[r0:r1, m * chunk:(m + 1) * chunk]
        return face_table[ids.long()]
    return sweep_plain(visit_rows, (counts + (chunk - 1)) // chunk,
                       channels, height, width, tiles_x, num_tiles, tile_h,
                       tile_w, chunk)


def dense_sweep(face_table, face_ids, counts, channels, height, width,
                tiles_x, num_tiles, tile_h, tile_w, chunk):
    """K7 wrapper: dense_sweep_plain's state, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    face_table [B*F', D] f32 (the images' tables stacked); face_ids
    [B*T, slots] int32 rows of it, batch-folded; counts [B*T] int32.  The
    kernel walks each list with K1's run walk at one face a visit
    (forward_blocks.sweep_shape(pix, 1, ..)), as K8 does; `chunk` is the
    plain version's."""
    from . import forward_blocks
    if not _cuda.on_cuda(face_table, face_ids, counts):
        return dense_sweep_plain(face_table, face_ids, counts, channels,
                                 height, width, tiles_x, num_tiles, tile_h,
                                 tile_w, chunk)
    runs, slots = face_ids.shape
    width_d = face_table.shape[1]
    pix = tile_h * tile_w
    if pix > 1024:
        raise ValueError(f"dense_sweep runs one thread per pixel: a "
                         f"{tile_h}x{tile_w} tile exceeds 1024 threads")
    shape = forward_blocks._sweep_args(face_table[:, None], pix)
    state = torch.empty(runs, channels + 9, pix, device=face_table.device)
    DENSE_SWEEP(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("face_ids", face_ids, torch.int32),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("state", state, torch.float32),
        runs, slots, num_tiles, tiles_x, tile_h, tile_w, width_d, channels,
        height, width, 2.0 / width, 2.0 / height, *shape, _cuda.stream())
    return state


def pack(vertices, vertex_colors, faces, height, width, tile_h, tile_w,
         chunk):
    """The dense schedule for a batch: (face_table [B*F', D], face_ids
    [B*T, slots] int32 rows of it, counts [B*T] int32, dropped [B]), the
    per-tile lists of forward_pallas._pack_faces folded over the batch."""
    batch, num_faces = faces.shape[:2]
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_chunks = max(1, _cdiv(forward_pallas.tile_face_cap(num_faces), chunk))
    face_data, face_ids, counts, dropped = forward_pallas._pack_faces(
        vertices, vertex_colors, faces, height, width, num_chunks, tiles_y,
        tiles_x, chunk, tile_h, tile_w)
    rows = face_data.shape[1]
    boff = torch.arange(batch, dtype=torch.int32, device=faces.device) * rows
    return (face_data.reshape(batch * rows, -1),
            (face_ids + boff[:, None, None]).reshape(batch * tiles_y * tiles_x,
                                                     -1),
            counts.reshape(-1), dropped)


def rasterise_batch(background, vertices, vertex_colors, faces,
                    tile_h=None, tile_w=None, chunk=CHUNK):
    """Batched forward rasterisation through the dense backend.

    Returns (pixels [B, H, W, C], reference.RasterAux) with `dropped`,
    the per-image hits beyond the per-tile cap; visibility matches the
    other backends bit-exactly on tie-free scenes."""
    batch, height, width, channels = background.shape
    if faces.shape[1] == 0:
        return reference.rasterise_batch(background, vertices, vertex_colors,
                                         faces)
    if tile_h is None or tile_w is None:
        tile_h, tile_w = tile_shape(height, width)
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_tiles = tiles_y * tiles_x
    face_table, face_ids, counts, dropped = pack(
        vertices, vertex_colors, faces, height, width, tile_h, tile_w, chunk)
    state = dense_sweep(face_table, face_ids, counts, channels, height, width,
                        tiles_x, num_tiles, tile_h, tile_w, chunk)
    state = state.reshape(batch, num_tiles, channels + 9, tile_h * tile_w)
    pixels, aux = finalize(state, background, height, width, tiles_y,
                           tiles_x, tile_h=tile_h, tile_w=tile_w)
    return pixels, aux._replace(dropped=dropped)
