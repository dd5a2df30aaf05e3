"""The "mxu" gradient: the per-face masked pixel sums as tensor-core matrix
products (PyTorch port of dirt_tpu/ops/grad_mxu.py).

Same gradient as backward.rasterise_grad_batch, with the reductions of
grad_dense._chunk_sums reformulated per (image, band, face chunk) as one
contraction over the band's pixels:

    S = M @ V,  M[face, pixel] = the {0, 1} winner mask,
                V[pixel, plane] = face-independent value planes.

The face-dependent factors (corner clip x and y in the viewport chain
rule) factor out of the pixel sums,

    gw_k = -sum_m x_m * sum_px[b_k b_m Px] - sum_m y_m * sum_px[b_k b_m Py],

leaving 18 position planes (3 b*Ax, 3 b*Ay, 6 symmetric b_k b_m Px, 6
b_k b_m Py) and 3C colour planes (bpre_k * grad_c), combined at face
count after the contraction.  The masks of the post-dilation face ids
(position columns) and the pre-dilation ones (colour columns) stack as
2 * CHUNK rows of one product.  The mask is exact in bf16, so only the f32
value planes are split, each into a bf16 (hi, mid, lo) triple with
hi + mid + lo equal to the value to ~2^-24 relative: three bf16 products
accumulated in f32 give the f32 sums up to summation order.

  * the value planes come from the block-binned gradient's pre-pass,
    prepass_fused.plane_stack (kernel K2 on CUDA) at a (BAND_H, W) tile,
    whose tile-major layout is already band-major pixels; they are the
    values of backward.grad_prepass bit for bit;
  * _pack_grad_bands bins faces to bands (1-D row intervals widened two
    pixels: dilation plus rounding slack), hits first in draw order;
  * mxu_grad (kernel K10 on CUDA) computes the rows, zeros for dead chunks
    (their rows scatter through sorted_orig, whose padding points at face
    0);
  * the post-pass splits the position and colour quadrants, combines gw
    from the corner x and y, and scatters the rows into vertex rows.

dirt_tpu pads each band's width to 128 lanes; the port does not.  Pixels
of the last band past the image edge get face id -2 (matching no face)
and zero values.
"""

import collections

import torch

from . import (_cuda, backward, forward_pallas, geometry, grad_dense,
               prepass_fused)

BAND_H = 16
CHUNK = 128
_BIG = forward_pallas._BIG
# Symmetric b_k * b_m product-plane pairs.
_QPAIRS = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
_NPOS = 3 + 3 + 6 + 6   # b*Ax (3), b*Ay (3), Qx (6), Qy (6)

MXU_GRAD = _cuda.Kernel(
    "mxu_grad", "dirt_mxu_grad",
    [_cuda.ptr] * 5 + [_cuda.i32] * 7 + [_cuda.ptr],
    replaces="dirt_tpu/ops/grad_mxu.py:122", source="mxu_grad.cu")


def _cdiv(a, b):
    return -(-a // b)


def _pack_grad_bands(vertices, faces, height, width, num_chunks, num_bands):
    """Per-band hits-first face lists of a batch (1-D row-interval binning).

    Returns (face_ids [B, bands, NC * CHUNK] f32, counts [B, bands] i32 cut
    to the slots, sorted_orig [B, bands, NC * CHUNK] i32).  Padded list
    entries get face id -3 (never a face, background -1 or a padded pixel
    -2) and original face 0."""
    batch, num_faces = faces.shape[:2]
    device = vertices.device
    setup = geometry.face_setup(vertices, faces)
    # The gradient table's rows: widened one pixel more for dilation.
    row0, row1, _, _ = forward_pallas.pixel_bbox(
        geometry.gather_corners(vertices, faces), setup.valid, height, width,
        widen=1)

    max_rows = num_chunks * CHUNK
    pad_rows = max(max_rows, num_faces) - num_faces
    pad = lambda a, v: torch.nn.functional.pad(a, (0, pad_rows), value=v)
    row0, row1 = pad(row0, _BIG), pad(row1, -1)
    base = torch.arange(num_faces, dtype=torch.int32, device=device)
    base_orig = torch.nn.functional.pad(base, (0, pad_rows), value=0)
    base_fid = torch.nn.functional.pad(base, (0, pad_rows), value=-3)

    band_r0 = torch.arange(num_bands, dtype=torch.int32,
                           device=device) * BAND_H
    overlap = ((row0[:, None, :] <= (band_r0 + BAND_H - 1)[:, None])
               & (row1[:, None, :] >= band_r0[:, None]))  # [B, bands, NCK]
    order, counts = forward_pallas.hits_first(overlap, max_rows)
    order = order.long()
    return (base_fid[order].to(torch.float32), counts.clamp(max=max_rows),
            base_orig[order])


def band_planes(pixels, grad_pixels, aux):
    """The pre-pass of a batch as band-major planes: (ids [B, bands, 2, PIX]
    f32, the post- and pre-dilation face ids, -2 on pixels past the image;
    values [B, bands, 18 + 3C, PIX] f32, plane-major (dirt_tpu stacks them
    pixel-major for its MXU; on the GPU a plane's pixels are contiguous so
    that K10 copies them 16 bytes at a time); dilated [B, H, W] bool),
    PIX = BAND_H * W."""
    batch, height, width, channels = pixels.shape
    num_bands = _cdiv(height, BAND_H)
    pix = BAND_H * width
    n_planes, L = grad_dense.plane_layout("all", channels)
    np_dma = _cdiv(n_planes, 8) * 8
    planes, dilated = prepass_fused.plane_stack(pixels, grad_pixels, aux,
                                                BAND_H, width, np_dma)
    planes = planes.reshape(batch, num_bands, np_dma, pix)
    plane = lambda i: planes[:, :, i]                       # [B, bands, PIX]
    b = [plane(L["bary_d"] + k) for k in range(3)]
    ax, ay, px, py = (plane(L[n]) for n in ("ax", "ay", "px", "py"))
    # dirt_tpu's expressions, each product written into its plane.
    factors = ([(b[k], ax) for k in range(3)]
               + [(b[k], ay) for k in range(3)]
               + [(b[k] * b[m], px) for k, m in _QPAIRS]
               + [(b[k] * b[m], py) for k, m in _QPAIRS]
               + [(plane(L["bary_pre"] + k), plane(L["grad"] + c))
                  for k in range(3) for c in range(channels)])
    values = torch.empty(batch, num_bands, len(factors), pix,
                         device=pixels.device)
    for i, (x, y) in enumerate(factors):
        torch.mul(x, y, out=values[:, :, i])
    ids = planes[:, :, [L["face_d"], L["face_pre"]]]
    if num_bands * BAND_H > height:
        row = (torch.arange(num_bands, device=pixels.device)[:, None] * BAND_H
               + torch.arange(pix, device=pixels.device) // width)
        ids = torch.where((row < height)[:, None], ids, -2.0)
    return ids, values, dilated


def split_bf16(values):
    """The bf16 (hi, mid, lo) triple of f32 values, stacked on a new axis
    -3: [..., P, PIX] -> [..., 3, P, PIX] bf16, hi + mid + lo == values to
    ~2^-24 relative (each residual keeps 8 more mantissa bits).  Each part
    is rounded (to nearest, ties to even, as dirt_tpu's astype) straight
    into its slot.  Eager torch rounds each step; never put torch.compile
    over it (an algebraic simplifier may cancel v - f32(bf16(v)) to
    zero)."""
    out = torch.empty(values.shape[:-2] + (3,) + values.shape[-2:],
                      dtype=torch.bfloat16, device=values.device)
    hi, mid, lo = out.unbind(-3)
    hi.copy_(values)
    res = values - hi.to(torch.float32)
    mid.copy_(res)
    lo.copy_(res - mid.to(torch.float32))
    return out


def mxu_grad_plain(face_ids, counts, ids, values, chunk):
    """Rows [B, bands * NC, 2 * chunk, P] f32 of dirt_tpu's _grad_kernel:
    for band t's chunk c (row t * NC + c), masks [2 * chunk, PIX] -- the
    post-dilation ids equal to the chunk's face ids, then the pre-dilation
    ones -- times each split group of `values` [B, bands, 3, PIX, P],
    summed over the groups in f32 (hi, then mid, then lo); zeros where
    c * chunk >= counts.  values are plane-major, [B, bands, 3, P, PIX]."""
    batch, bands, _, pix = ids.shape
    num_chunks = face_ids.shape[-1] // chunk
    groups = values.to(torch.float32).transpose(-1, -2)   # [B, T, 3, PIX, P]
    out = torch.zeros(batch, bands, num_chunks, 2 * chunk, values.shape[-2],
                      device=values.device)
    for c in range(num_chunks):
        fid = face_ids[:, :, c * chunk:(c + 1) * chunk, None]  # [B, T, K, 1]
        masks = torch.cat([ids[:, :, 0:1] == fid, ids[:, :, 1:2] == fid],
                          dim=2).to(torch.float32)        # [B, T, 2K, PIX]
        total = masks @ groups[:, :, 0]
        total = total + masks @ groups[:, :, 1]
        total = total + masks @ groups[:, :, 2]
        live = (c * chunk < counts)[..., None, None]
        out[:, :, c] = torch.where(live, total, 0.0)
    return out.reshape(batch, bands * num_chunks, 2 * chunk, -1)


# The launch shape of K10 (mxu_grad.cu's constants): WARPS warps a block,
# each holding up to TILES m16 tiles of mask rows; a band's pixels split
# over a cluster of SPLIT blocks; STAGE_BYTES of shared memory a ring stage
# (the two id planes and three groups of 32 padded value rows of 64
# pixels), DEPTH stages, or COMBINE_BYTES of partial rows where they take
# more; then TABLE_BYTES (the block's sorted face ids and positions, the
# stages' tile marks).
WARPS = 16
TILES = 4
SPLIT = 2
DEPTH = 4
STAGE_BYTES = 2 * 64 * 4 + 3 * 32 * 72 * 2
COMBINE_BYTES = WARPS * TILES * 32 * 16 * 4
TABLE_BYTES = WARPS * TILES * 8 * 8 + 2 * 4 * 2 * 4

MxuShape = collections.namedtuple("MxuShape", "chunks smem")


def mxu_shape(chunk, num_chunks, optin):
    """The MxuShape of a K10 launch on `num_chunks` list chunks of `chunk`
    faces a band, under `optin` bytes of shared memory a block:
      chunks  list chunks a block serves (the band's 2 * chunk mask rows a
              chunk, in m16 tiles): all of them where WARPS * TILES tiles
              hold them, else as many as fit (a group of chunks a cluster);
      smem    bytes of dynamic shared memory: the larger of the ring
              (DEPTH * STAGE_BYTES) and the partial rows, then TABLE_BYTES.
    Raises where the chunk or the shared memory does not fit."""
    if chunk % 16 or chunk > 512:
        raise ValueError(f"K10 takes chunks of a multiple of 16 faces, at "
                         f"most 512, not {chunk}")
    chunks = min(num_chunks, WARPS * TILES // (chunk // 8))
    smem = max(DEPTH * STAGE_BYTES, COMBINE_BYTES) + TABLE_BYTES
    if smem > optin:
        raise ValueError(f"{smem} bytes of stages exceed the {optin}-byte "
                         f"shared memory of a block")
    return MxuShape(chunks, smem)


def mxu_grad(face_ids, counts, ids, values, chunk):
    """K10 wrapper: mxu_grad_plain's rows, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    face_ids [B, bands, NC * chunk] f32; counts [B, bands] int32; ids
    [B, bands, 2, PIX] f32; values [B, bands, 3, P, PIX] bf16 (the split
    groups, plane-major), PIX a multiple of 8."""
    if not _cuda.on_cuda(face_ids, counts, ids, values):
        return mxu_grad_plain(face_ids, counts, ids, values, chunk)
    batch, bands, _, pix = ids.shape
    ncols = values.shape[-2]
    slots = face_ids.shape[-1]
    if slots % chunk:
        raise ValueError(f"{chunk}-face chunks do not divide the {slots} "
                         f"slots")
    if pix % 8:
        raise ValueError(f"mxu_grad copies 8 pixels at a time: a band of "
                         f"{pix} pixels is not a multiple of 8")
    num_chunks = slots // chunk
    shape = mxu_shape(chunk, num_chunks,
                      _cuda.shared_memory_optin(face_ids.device))
    out = torch.empty(batch, bands * num_chunks, 2 * chunk, ncols,
                      device=values.device)
    MXU_GRAD(
        _cuda.check("face_ids", face_ids, torch.float32),
        _cuda.check("counts", counts, torch.int32, (batch, bands)),
        _cuda.check("ids", ids, torch.float32),
        _cuda.check("values", values, torch.bfloat16,
                    (batch, bands, 3, ncols, pix)),
        _cuda.check("out", out, torch.float32),
        batch * bands, num_chunks, chunk, pix, ncols, shape.chunks,
        shape.smem, _cuda.stream())
    return out


def rasterise_grad_batch(vertices, faces, pixels, grad_pixels, aux):
    """The mxu gradient assembly; the contract of
    backward.rasterise_grad_batch for parts="all" without a colour
    cotangent (all arguments [B, ...])."""
    batch, height, width, channels = pixels.shape
    num_vertices = vertices.shape[1]
    num_faces = faces.shape[1]
    if num_faces == 0:
        return grad_dense.no_face_grads(vertices, grad_pixels, grad_pixels)

    ids, values, dilated = band_planes(pixels, grad_pixels, aux)
    num_chunks = max(1, _cdiv(forward_pallas.tile_face_cap(num_faces), CHUNK))
    num_bands = _cdiv(height, BAND_H)
    face_ids, counts, sorted_orig = _pack_grad_bands(
        vertices, faces, height, width, num_chunks, num_bands)
    sums = mxu_grad(face_ids, counts, ids, split_bf16(values), CHUNK)

    # Post-pass: the post-dilation mask rows pair with the position
    # columns, the pre-dilation rows with the colour columns (the cross
    # quadrants are padding); then the face-dependent combination.
    rows_n = num_bands * num_chunks * CHUNK
    sums = sums.reshape(batch, -1, 2, CHUNK, sums.shape[-1])
    sums_pos = sums[:, :, 0, :, :_NPOS].reshape(batch, rows_n, _NPOS)
    sums_col = sums[:, :, 1, :, _NPOS:].reshape(batch, rows_n, 3, channels)
    orig = sorted_orig.reshape(batch, rows_n, 1).long()
    corner_vids = torch.take_along_dim(faces, orig, dim=1)      # [B, R, 3]
    flat_vids = corner_vids.reshape(batch, -1).long()
    cx = torch.take_along_dim(vertices[..., 0], flat_vids, dim=1).reshape(
        batch, rows_n, 3)
    cy = torch.take_along_dim(vertices[..., 1], flat_vids, dim=1).reshape(
        batch, rows_n, 3)
    gx, gy = sums_pos[..., 0:3], sums_pos[..., 3:6]
    qx, qy = sums_pos[..., 6:12], sums_pos[..., 12:18]
    qindex = {pair: i for i, pair in enumerate(_QPAIRS)}
    gw = []
    for k in range(3):
        total = 0.
        for m in range(3):
            i = qindex[(min(k, m), max(k, m))]
            total = total + cx[..., m] * qx[..., i] + cy[..., m] * qy[..., i]
        gw.append(-total)
    face_grads = torch.cat([torch.stack([gx, gy, torch.stack(gw, dim=-1)],
                                        dim=-1), sums_col], dim=-1)
    boff = (torch.arange(batch, dtype=torch.int32, device=faces.device)
            * num_vertices)[:, None, None]
    grad_vertices, grad_vertex_colors = grad_dense.scatter_face_grads(
        face_grads, corner_vids + boff, batch, num_vertices, channels, "all")
    covered_pre = aux.indices[..., 0] >= 0
    return backward.RasteriseGrads(
        torch.where(covered_pre[..., None], 0.0, grad_pixels), grad_vertices,
        grad_vertex_colors, backward.debug_image(dilated, grad_pixels))
