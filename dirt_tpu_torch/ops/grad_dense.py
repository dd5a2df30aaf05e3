"""The tile-major "dense" gradient and the reduction math every gradient
kernel shares (PyTorch port of dirt_tpu/ops/grad_dense.py).

  * the per-face masked pixel reductions (_chunk_sums), their plane-stack
    layout, the plain pre-pass that builds the stack, and the face-row ->
    vertex scatter, shared with the block-binned gradient
    (ops/grad_blocks.py);
  * the dense gradient: prepass_fused.gradient_planes (kernel K2 on CUDA)
    builds the tile-major planes, grad_tables._pack_grad_faces gives each
    tile its exact hits-first face list, dense_grad_reduce (kernel K9 on
    CUDA) writes one row of sums per (tile, list slot) -- zeros for the
    slots of dead chunks -- and scatter_face_grads sums the rows into
    vertex rows through each slot's original face (sorted_orig).

The dense gradient's tile is 32x128 pixels, dirt_tpu's own: its rows are
O(T x slots x d_out), ~9.4 MB at the bench size against ~151 MB at 16x16
tiles.  K9 runs one warp per face slot over the slot's window (the
face's table bbox clipped to the tile, face_windows), so the tile's pixel
count is not bounded by a block's threads; its launch shape is
dense_shape.

For face f with original index fid, and corner k:

    gx_k = sum over pixels with face_d == fid of bary_d_k * ax
    gy_k = sum ... of bary_d_k * ay
    gw_k = -sum ... of bary_d_k * (Px * cx + Py * cy),
           cx = (bary_d_0 x0 + bary_d_1 x1) + bary_d_2 x2  (cy alike)
    colour_kc = sum over pixels with face_pre == fid of bary_pre_k * grad_c

Padded face rows (fid -1) and padded pixels (all-zero planes) contribute
exact zeros: every product carries an ax/ay/Px/Py/bary_pre factor that the
pre-pass zeroes outside coverage.
"""

import collections

import torch

from . import _cuda, backward, forward_pallas, grad_tables

TILE_H = 32
TILE_W = 128
CHUNK = 64
# Plain reduction: tiles per vectorised step, bounding the [tiles, chunk,
# PIX] planes at ~2^25 elements.
_PLAIN_ELEMENTS = 1 << 25


def _cdiv(a, b):
    return -(-a // b)


def plane_layout(parts, channels):
    """(n_planes, {plane name: index}) of the plane stack for `parts`:
        all:      ax ay Px Py bary_d0-2 face_d bary_pre0-2 face_pre grad..
        position: ax ay Px Py bary_d0-2 face_d                (8 planes)
        color:    bary_pre0-2 face_pre grad..                 (4+C planes)
    """
    if parts == "position":
        return 8, dict(ax=0, ay=1, px=2, py=3, bary_d=4, face_d=7)
    if parts == "color":
        return 4 + channels, dict(bary_pre=0, face_pre=3, grad=4)
    return 12 + channels, dict(ax=0, ay=1, px=2, py=3, bary_d=4, face_d=7,
                               bary_pre=8, face_pre=11, grad=12)


def d_out_for(parts, channels):
    """Per-face output width: per corner (gx, gy, gw) and/or `channels`
    colour rows, laid out [chunk, 3, d_corner]."""
    if parts == "position":
        return 9
    if parts == "color":
        return 3 * channels
    return 9 + 3 * channels


def _chunk_sums(col, plane, channels, parts="all"):
    """Masked per-face reductions for one chunk: [..., K, d_out].

    `col(i)` returns gradient-table column i as [..., K, 1]; `plane(i)`
    returns plane i as [..., 1, PIX] (plane_layout order)."""
    _, L = plane_layout(parts, channels)
    fid = col(4)
    want_pos = parts in ("all", "position")
    want_col = parts in ("all", "color")
    if want_pos:
        mask_d = plane(L["face_d"]) == fid
        bd = L["bary_d"]
        cx = ((plane(bd) * col(6) + plane(bd + 1) * col(7))
              + plane(bd + 2) * col(8))
        cy = ((plane(bd) * col(9) + plane(bd + 1) * col(10))
              + plane(bd + 2) * col(11))
        p = plane(L["px"]) * cx + plane(L["py"]) * cy
    if want_col:
        mask_pre = plane(L["face_pre"]) == fid

    def rsum(a):
        return a.sum(dim=-1, keepdim=True)

    sums = []
    for k in range(3):
        if want_pos:
            wd = torch.where(mask_d, plane(L["bary_d"] + k), 0.0)
            sums.append(rsum(wd * plane(L["ax"])))
            sums.append(rsum(wd * plane(L["ay"])))
            sums.append(-rsum(wd * p))
        if want_col:
            wp = torch.where(mask_pre, plane(L["bary_pre"] + k), 0.0)
            for c in range(channels):
                sums.append(rsum(wp * plane(L["grad"] + c)))
    return torch.cat(sums, dim=-1)


def prepass_and_planes(pixels, grad_pixels, aux, parts, color_cotangent=None):
    """The plain pre-pass for `parts` and its [B, NP, H, W] plane stack.
    Returns (planes, grad_background, dilated).

    parts="color" needs no Scharr or dilation (colour gradients read
    pre-dilation coverage).  `color_cotangent` (parts="all" only) takes the
    cotangent planes and the background gradient from it, while the
    position planes still come from pixels / grad_pixels.
    """
    f32 = lambda a: a.to(torch.float32)[:, None]
    chan = lambda a: a.movedim(-1, 1)
    covered_pre = aux.indices[..., 0] >= 0
    if parts == "color":
        grad_background = torch.where(covered_pre[..., None], 0.0,
                                      grad_pixels)
        bary_pre = torch.where(covered_pre[..., None], aux.barycentric, 0.0)
        planes = torch.cat([chan(bary_pre), f32(aux.face_index),
                            chan(grad_pixels)], dim=1)
        return planes, grad_background, torch.zeros_like(covered_pre)
    pre = backward.grad_prepass(pixels, grad_pixels, aux)
    position = [torch.stack([pre.ax, pre.ay, pre.px_t, pre.py_t], dim=1),
                chan(pre.bary_d), f32(pre.face_d)]
    if parts == "position":
        return torch.cat(position, dim=1), pre.grad_background, pre.dilated
    cot = grad_pixels if color_cotangent is None else color_cotangent
    grad_background = torch.where(covered_pre[..., None], 0.0, cot)
    planes = torch.cat(position + [chan(pre.bary_pre), f32(pre.face_pre),
                                   chan(cot)], dim=1)
    return planes, grad_background, pre.dilated


def scatter_face_grads(face_grads, seg, batch, num_vertices, channels,
                       parts):
    """Sums per-corner rows [..., 3, d_corner] into per-vertex
    (grad_vertices, grad_vertex_colors) by the flat vertex ids `seg`
    (batch-offset), zero-filling the parts not computed.  index_add_ is
    atomic on CUDA: its summation order varies from run to run."""
    d_corner = d_out_for(parts, channels) // 3
    rows = face_grads.reshape(-1, d_corner)
    summed = torch.zeros(batch * num_vertices, d_corner,
                         device=face_grads.device)
    summed.index_add_(0, seg.reshape(-1).long(), rows)
    summed = summed.reshape(batch, num_vertices, d_corner)
    zeros = torch.zeros(batch, num_vertices, device=face_grads.device)
    if parts == "color":
        return torch.zeros(batch, num_vertices, 4,
                           device=face_grads.device), summed
    grad_vertices = torch.stack(
        [summed[..., 0], summed[..., 1], zeros, summed[..., 2]], dim=-1)
    if parts == "position":
        return grad_vertices, torch.zeros(batch, num_vertices, channels,
                                          device=face_grads.device)
    return grad_vertices, summed[..., 3:]


def no_face_grads(vertices, grad_pixels, cotangent):
    """The gradients of a mesh with no faces: the cotangent passes to the
    background, nothing reaches the vertices."""
    batch, height, width, _ = grad_pixels.shape
    num_vertices = vertices.shape[1]
    device = grad_pixels.device
    return backward.RasteriseGrads(
        grad_background=cotangent,
        grad_vertices=torch.zeros(batch, num_vertices, 4, device=device),
        grad_vertex_colors=torch.zeros(batch, num_vertices,
                                       cotangent.shape[-1], device=device),
        debug=backward.debug_image(
            torch.zeros(batch, height, width, dtype=torch.bool,
                        device=device), grad_pixels))


# --------------------------------------------------------------------------
# K9: the tile-major reduction
# --------------------------------------------------------------------------

DENSE_GRAD_REDUCE = _cuda.Kernel(
    "dense_grad_reduce", "dirt_dense_grad_reduce",
    [_cuda.ptr] * 5 + [_cuda.i32] * 25 + [_cuda.ptr],
    replaces=("dirt_tpu/ops/grad_dense.py:193, "
              "dirt_tpu/ops/grad_dense.py:170"),
    source="dense_grad.cu")


def face_windows(face_table, face_ids, height, width, tile_h, tile_w):
    """The window K9 scans for each slot: the face's table bbox (columns
    0-3, widened for dilation) clipped to the slot's tile, in tile-local
    (r0, r1, c0, c1), inclusive: [B*T, slots, 4] int64, empty where r0 > r1
    or c0 > c1 (padded rows, faces that miss the tile)."""
    tiles_x = _cdiv(width, tile_w)
    tiles = _cdiv(height, tile_h) * tiles_x
    t = torch.arange(face_ids.shape[0], device=face_ids.device) % tiles
    oy = (t // tiles_x * tile_h)[:, None]
    ox = (t % tiles_x * tile_w)[:, None]
    box = face_table[face_ids.long(), :4].long()
    return torch.stack([(box[..., 0] - oy).clamp(min=0),
                        (box[..., 1] - oy).clamp(max=tile_h - 1),
                        (box[..., 2] - ox).clamp(min=0),
                        (box[..., 3] - ox).clamp(max=tile_w - 1)], dim=-1)


def window_pixels(windows):
    """Pixels of each face_windows window (0 where empty)."""
    rows = (windows[..., 1] - windows[..., 0] + 1).clamp(min=0)
    return rows * (windows[..., 3] - windows[..., 2] + 1).clamp(min=0)


def _tile_grid(runs, pix, height, width, tile_h, tile_w):
    """(tiles_x, tiles per image) of runs of `pix`-pixel tiles; raises
    where they are not whole images of tile_h x tile_w tiles."""
    tiles_x = _cdiv(width, tile_w)
    tiles = _cdiv(height, tile_h) * tiles_x
    if pix != tile_h * tile_w or runs % tiles:
        raise ValueError(f"{runs} runs of {pix} pixels are not whole images "
                         f"of {tiles} {tile_h}x{tile_w} tiles")
    return tiles_x, tiles


def dense_grad_reduce_plain(face_table, face_ids, counts, planes, channels,
                            parts, chunk, height, width, tile_h, tile_w):
    """Rows [B*T, slots, d_out]: for every live chunk of tile run bt's face
    list (chunk c with c * chunk < counts[bt]), _chunk_sums of the chunk's
    faces over the tile's planes; zeros for the dead chunks.  height,
    width, tile_h and tile_w place run bt's tile in its image (tile bt %
    T, row-major); K9 clips each face's bbox to it, the plain version sums
    over the whole tile."""
    runs, slots = face_ids.shape
    pix = planes.shape[-1]
    _tile_grid(runs, pix, height, width, tile_h, tile_w)
    out = torch.zeros(runs, slots, d_out_for(parts, channels),
                      device=planes.device)
    step = max(1, _PLAIN_ELEMENTS // (chunk * pix))
    for r0 in range(0, runs, step):
        r1 = min(runs, r0 + step)
        n = counts[r0:r1]
        tile = planes[r0:r1]
        plane = lambda i: tile[:, i:i + 1, :]              # [R, 1, PIX]
        for c in range(_cdiv(int(n.max()), chunk)):
            rows = face_table[face_ids[r0:r1, c * chunk:(c + 1) * chunk]
                              .long()]                     # [R, K, _DF]
            col = lambda i: rows[:, :, i:i + 1]
            sums = _chunk_sums(col, plane, channels, parts)
            out[r0:r1, c * chunk:(c + 1) * chunk] = torch.where(
                (c * chunk < n)[:, None, None], sums, 0.0)
    return out


# --------------------------------------------------------------------------
# The launch shape of K9
# --------------------------------------------------------------------------

MAX_WARPS = 8          # warps a block (dense_grad.cu's kMaxWarps)
PER_WARP = 4           # face slots a warp takes in turn, at most

DenseShape = collections.namedtuple("DenseShape", "warps per_warp group")


def dense_shape(slots, channels, want_col):
    """The DenseShape of a K9 launch over `slots`-slot face lists:
      warps     warps a block: the largest power of two <= MAX_WARPS that
                divides `slots`;
      per_warp  face slots a warp takes in turn (a block: warps x
                per_warp consecutive slots): the largest power of two <=
                PER_WARP that divides slots / warps;
      group     colour channels a pass (_cuda.colour_group)."""
    warps = min(MAX_WARPS, slots & -slots)
    per_warp = min(PER_WARP, (slots // warps) & -(slots // warps))
    return DenseShape(warps, per_warp, _cuda.colour_group(channels, want_col))


def dense_grad_reduce(face_table, face_ids, counts, planes, channels, parts,
                      chunk, height, width, tile_h, tile_w):
    """K9 wrapper: dense_grad_reduce_plain's rows, by the CUDA kernel for
    CUDA tensors and by the plain version for CPU tensors.

    face_table [B*F', _DF] f32 (the images' gradient tables stacked);
    face_ids [B*T, slots] int32 rows of it, batch-folded, slots a multiple
    of `chunk`; counts [B*T] int32; planes [B*T, NP, PIX] f32 in
    plane_layout(parts, channels) order (NP may include zero pad planes),
    PIX = tile_h * tile_w."""
    if not _cuda.on_cuda(face_table, face_ids, counts, planes):
        return dense_grad_reduce_plain(face_table, face_ids, counts, planes,
                                       channels, parts, chunk, height, width,
                                       tile_h, tile_w)
    runs, slots = face_ids.shape
    if slots % chunk:
        raise ValueError(f"{slots} slots are not whole {chunk}-slot chunks")
    np_stride, pix = planes.shape[1], planes.shape[2]
    n_planes, L = plane_layout(parts, channels)
    if np_stride < n_planes:
        raise ValueError(f"planes hold {np_stride} planes, the {parts!r} "
                         f"layout needs {n_planes}")
    tiles_x, tiles = _tile_grid(runs, pix, height, width, tile_h, tile_w)
    shape = dense_shape(slots, channels, parts in ("all", "color"))
    d_out = d_out_for(parts, channels)
    layout = [L.get(name, -1) for name in (
        "ax", "ay", "px", "py", "bary_d", "face_d", "bary_pre", "face_pre",
        "grad")]
    out = torch.empty(runs, slots, d_out, device=planes.device)
    DENSE_GRAD_REDUCE(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("face_ids", face_ids, torch.int32),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("planes", planes, torch.float32, (runs, np_stride, pix)),
        _cuda.check("out", out, torch.float32),
        runs, slots, chunk, face_table.shape[1], np_stride, pix, d_out,
        channels, int(parts in ("all", "position")), *layout, tile_h, tile_w,
        tiles_x, tiles, shape.group, shape.warps, shape.per_warp,
        _cuda.stream())
    return out


def pack(vertices, faces, height, width, tile_h, tile_w, chunk):
    """The dense gradient schedule for a batch: (face_table [B*F', _DF],
    face_ids [B*T, slots] int32 rows of it, counts [B*T] int32,
    sorted_orig [B, T * slots] int32), the per-tile lists of
    grad_tables._pack_grad_faces with the ids folded over the batch."""
    batch, num_faces = faces.shape[:2]
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_chunks = max(1, _cdiv(forward_pallas.tile_face_cap(num_faces), chunk))
    face_data, face_ids, counts, sorted_orig = grad_tables._pack_grad_faces(
        vertices, faces, height, width, num_chunks, tiles_y, tiles_x, chunk,
        tile_h, tile_w)
    rows = face_data.shape[1]
    boff = torch.arange(batch, dtype=torch.int32, device=faces.device) * rows
    return (face_data.reshape(batch * rows, grad_tables._DF),
            (face_ids + boff[:, None, None]).reshape(batch * tiles_y * tiles_x,
                                                     -1),
            counts.reshape(-1), sorted_orig.reshape(batch, -1))


def rasterise_grad_batch(vertices, faces, pixels, grad_pixels, aux,
                         parts="all", color_cotangent=None,
                         tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK):
    """Tile-major dense gradient assembly; the contract of
    backward.rasterise_grad_batch (all arguments [B, ...]), including
    `parts` and the fused-deferred `color_cotangent`."""
    from . import prepass_fused
    batch = pixels.shape[0]
    cot = grad_pixels if color_cotangent is None else color_cotangent
    channels = cot.shape[-1]
    num_vertices = vertices.shape[1]
    if faces.shape[1] == 0:
        return no_face_grads(vertices, grad_pixels, cot)
    planes, grad_background, dilated = prepass_fused.gradient_planes(
        pixels, grad_pixels, aux, parts, color_cotangent, tile_h, tile_w)
    face_table, face_ids, counts, sorted_orig = pack(
        vertices, faces, pixels.shape[1], pixels.shape[2], tile_h, tile_w,
        chunk)
    face_grads = dense_grad_reduce(face_table, face_ids, counts, planes,
                                   channels, parts, chunk, pixels.shape[1],
                                   pixels.shape[2], tile_h, tile_w)

    # Every (tile, slot) row goes to its original face's corners; padded
    # slots map to face 0 and carry exact zeros.
    d_out = d_out_for(parts, channels)
    face_grads = face_grads.reshape(batch, -1, 3, d_out // 3)
    corner_vids = torch.take_along_dim(faces, sorted_orig[..., None].long(),
                                       dim=1)
    boff = torch.arange(batch, dtype=torch.int32, device=faces.device)
    grad_vertices, grad_vertex_colors = scatter_face_grads(
        face_grads, corner_vids + (boff * num_vertices)[:, None, None], batch,
        num_vertices, channels, parts)
    return backward.RasteriseGrads(
        grad_background, grad_vertices, grad_vertex_colors,
        backward.debug_image(dilated, grad_pixels))
