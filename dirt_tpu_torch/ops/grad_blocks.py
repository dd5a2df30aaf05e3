"""Block-binned (CSR) face-major gradient assembly: the CUDA main path of
the backward (PyTorch port of dirt_tpu/ops/grad_blocks.py).

  * plane_stack (ops/prepass_fused.py, kernel K2 on CUDA) builds the
    per-pixel planes in tile-major layout;
  * the gradient face table (ops/grad_tables.py) is Morton-sorted and
    binned with the forward's hit test (kernel K4) at a one-pixel dilation,
    and build_runs lays the TRANSPOSED hits out as CSR runs: per face
    block, the tiles its faces can reach;
  * grad_reduce (kernel K3 on CUDA) accumulates each face's masked sums
    (grad_dense's reductions) over its block's tiles, in tile order, into
    one deterministic row per face -- no atomics;
  * grad_dense.scatter_face_grads sums the face rows into vertex rows.

Tile shape and block size are parameters; the defaults are this port's GPU
shape (16x16-pixel tiles, 32-face blocks with one thread per face), and the
tests use the JAX package's (8x128 tiles, 128-face blocks) to compare.
"""

import torch

from . import (_cuda, backward, forward_blocks, grad_dense, grad_tables,
               prepass_fused)

TILE_H = 16
TILE_W = 16
CHUNK = 32
_BBOX = (0, 1, 2, 3)

GRAD_REDUCE = _cuda.Kernel(
    "grad_reduce", "dirt_grad_reduce",
    [_cuda.ptr] * 6 + [_cuda.i32] * 17 + [_cuda.ptr],
    replaces="dirt_tpu/ops/grad_blocks.py:147")


def _cdiv(a, b):
    return -(-a // b)


def grad_reduce_plain(face_table, planes, starts, counts, tile_ids, channels,
                      parts):
    """Per-face sums [B*NB, chunk, d_out]: run r (a face block) adds
    grad_dense._chunk_sums over the tiles tile_ids[starts[r] : starts[r] +
    counts[r]] in order.  All runs advance one visit per step."""
    runs = starts.shape[0]
    chunk = face_table.shape[1]
    d_out = grad_dense.d_out_for(parts, channels)
    acc = torch.zeros(runs, chunk, d_out, device=face_table.device)
    col = lambda i: face_table[:, :, i:i + 1]             # [R, K, 1]
    st = starts.long()
    for m in range(int(counts.max()) if runs else 0):
        live = m < counts
        tid = tile_ids[(st + m).clamp(max=tile_ids.shape[0] - 1)].long()
        tile = planes[tid]                                # [R, NP, PIX]
        plane = lambda i: tile[:, i:i + 1, :]             # [R, 1, PIX]
        sums = grad_dense._chunk_sums(col, plane, channels, parts)
        acc = torch.where(live[:, None, None], acc + sums, acc)
    return acc


def grad_reduce(face_table, planes, starts, counts, tile_ids, channels,
                parts):
    """K3 wrapper: grad_reduce_plain's rows, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    face_table [B*NB, chunk, _DF] f32; planes [B*T, NP, PIX] f32 in
    plane_layout(parts, channels) order; starts, counts [B*NB] and
    tile_ids [B*S] int32, batch-folded (ids index the flat planes)."""
    if not _cuda.on_cuda(face_table, planes, starts, counts, tile_ids):
        return grad_reduce_plain(face_table, planes, starts, counts,
                                 tile_ids, channels, parts)
    runs, chunk, width_d = face_table.shape
    n_planes, pix = planes.shape[1], planes.shape[2]
    if chunk > 1024:
        raise ValueError(f"grad_reduce runs one thread per face: a {chunk}-"
                         "face block exceeds 1024 threads")
    d_out = grad_dense.d_out_for(parts, channels)
    _, L = grad_dense.plane_layout(parts, channels)
    layout = [L.get(name, -1) for name in (
        "ax", "ay", "px", "py", "bary_d", "face_d", "bary_pre", "face_pre",
        "grad")]
    out = torch.empty(runs, chunk, d_out, device=face_table.device)
    GRAD_REDUCE(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("planes", planes, torch.float32),
        _cuda.check("starts", starts, torch.int32, (runs,)),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("tile_ids", tile_ids, torch.int32),
        _cuda.check("out", out, torch.float32),
        runs, chunk, width_d, n_planes, pix, d_out, channels,
        int(parts in ("all", "position")), *layout, _cuda.stream())
    return out


def pack(vertices, faces, height, width, tile_h, tile_w, chunk):
    """The gradient schedule for a batch: (face_table [B*NB, chunk, _DF],
    starts [B*NB], counts [B*NB], tile_ids [B*S], row_face [B, NB*chunk]),
    CSR ids folded over the batch; row_face maps table rows to faces."""
    batch, num_faces = faces.shape[:2]
    num_blocks = _cdiv(num_faces, chunk)
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_tiles = tiles_y * tiles_x
    num_slots = forward_blocks.slots_per_image(num_blocks, num_tiles)

    face_data = grad_tables._grad_face_table(
        vertices, faces, height, width, num_blocks * chunk - num_faces)
    order = forward_blocks.spatial_order(face_data, _BBOX, tile_h, tile_w)
    face_data = torch.take_along_dim(face_data, order[..., None].long(),
                                     dim=1).contiguous()
    # dilate=1: the gradient support is coverage dilated one pixel.
    hit = forward_blocks.hit_matrix(
        face_data, _BBOX, num_blocks, chunk, tiles_y, tiles_x, tile_h,
        tile_w, edge_cols=12, height=height, width=width, dilate=1)
    # Transposed CSR: runs are blocks, items are tiles.  The dropped count
    # is the forward's to report (its schedule is a near-subset of this).
    starts, counts, tile_ids, _ = forward_blocks.build_runs(
        hit.transpose(1, 2), num_slots)
    boff = torch.arange(batch, dtype=torch.int32, device=faces.device)[:, None]
    return (face_data.reshape(batch * num_blocks, chunk, grad_tables._DF),
            (starts + num_slots * boff).reshape(-1),
            counts.reshape(-1),
            (tile_ids + num_tiles * boff).reshape(-1),
            order)


def rasterise_grad_batch(vertices, faces, pixels, grad_pixels, aux,
                         parts="all", color_cotangent=None,
                         tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK):
    """Block-binned face-major gradient assembly; the contract of
    backward.rasterise_grad_batch (all arguments [B, ...]), including
    `parts` and the fused-deferred `color_cotangent`."""
    batch, height, width, _ = pixels.shape
    channels = (pixels.shape[-1] if color_cotangent is None
                else color_cotangent.shape[-1])
    num_vertices = vertices.shape[1]
    num_faces = faces.shape[1]
    device = pixels.device
    cot = grad_pixels if color_cotangent is None else color_cotangent

    if num_faces == 0:
        return backward.RasteriseGrads(
            grad_background=cot,
            grad_vertices=torch.zeros(batch, num_vertices, 4, device=device),
            grad_vertex_colors=torch.zeros(batch, num_vertices, channels,
                                           device=device),
            debug=backward.debug_image(
                torch.zeros(batch, height, width, dtype=torch.bool,
                            device=device), grad_pixels))

    n_planes = grad_dense.plane_layout(parts, channels)[0]
    np_dma = _cdiv(n_planes, 8) * 8
    if parts == "color":
        planes, grad_background, dilated = grad_dense.prepass_and_planes(
            pixels, grad_pixels, aux, parts)
        planes = prepass_fused.tile_planes(planes, tile_h, tile_w, np_dma)
    else:
        planes, dilated = prepass_fused.plane_stack(
            pixels, grad_pixels, aux, tile_h, tile_w, np_dma, parts=parts,
            color_cotangent=color_cotangent)
        covered_pre = aux.indices[..., 0] >= 0
        grad_background = torch.where(covered_pre[..., None], 0.0, cot)

    face_table, starts, counts, tile_ids, row_face = pack(
        vertices, faces, height, width, tile_h, tile_w, chunk)
    face_grads = grad_reduce(face_table, planes, starts, counts, tile_ids,
                             channels, parts)

    # Rows map 1:1 to faces in table order; padded tail rows reduce to
    # zeros and scatter harmlessly into vertex 0.
    num_blocks = _cdiv(num_faces, chunk)
    d_out = grad_dense.d_out_for(parts, channels)
    face_grads = face_grads.reshape(batch, num_blocks * chunk, 3, d_out // 3)
    faces_padded = torch.nn.functional.pad(
        faces, (0, 0, 0, num_blocks * chunk - num_faces))
    faces_padded = torch.take_along_dim(faces_padded,
                                        row_face[..., None].long(), dim=1)
    boff = (torch.arange(batch, dtype=torch.int32, device=device)
            * num_vertices)[:, None, None]
    grad_vertices, grad_vertex_colors = grad_dense.scatter_face_grads(
        face_grads, faces_padded + boff, batch, num_vertices, channels,
        parts)
    return backward.RasteriseGrads(
        grad_background, grad_vertices, grad_vertex_colors,
        backward.debug_image(dilated, grad_pixels))
