"""Block-binned (CSR) face-major gradient assembly: the CUDA main path of
the backward (PyTorch port of dirt_tpu/ops/grad_blocks.py).

  * plane_stack (ops/prepass_fused.py, kernel K2 on CUDA) builds the
    per-pixel planes in tile-major layout;
  * the gradient face table (ops/grad_tables.py; kernel K13 on CUDA
    writes it Morton-sorted, forward_blocks.face_table) is binned with
    the forward's hit test (kernel K4) at a one-pixel dilation,
    and build_runs (K12 on CUDA, which reads the transposed view in
    place) lays the TRANSPOSED hits out as CSR runs: per face block, the
    tiles its faces can reach;
  * grad_reduce (kernel K3 on CUDA) accumulates each face's masked sums
    (grad_dense's reductions) over its block's tiles, in tile order, into
    one deterministic row per face -- no atomics;
  * grad_dense.scatter_face_grads sums the face rows into vertex rows.

With FUSED off (a module constant that tests set) the transposed hits
are laid out as the slot schedule instead (forward_blocks.build_slots)
and slot_grad_reduce (kernel K6 on CUDA) walks each block's slots in K3's
order, so its rows equal K3's bit for bit; a block whose slots the static
budget cut keeps zero rows.  Both schedules are forward_blocks.schedule's,
given this pass (GRADIENT) as data.

Tile shape and block size are parameters; the defaults are this port's GPU
shape (16x16-pixel tiles, 32-face blocks) on both schedules, and the tests
use the JAX package's (8x128 tiles fused, 16x128 on slots, 128-face
blocks) to compare.  K3 and K6 share one launch shape, reduce_shape: P
pixel lanes per face, a ring of staged tiles and a colour group, computed
from the shapes and the device's opt-in shared memory.

Under a torch.profiler session each stage records a span
(utils/profiling): dirt.backward.prepass (K2), dirt.backward.table,
dirt.backward.hits (K4 at dilation 1; counter backward.hit_window),
dirt.backward.runs (the schedule; counter backward.dropped),
dirt.backward.reduce (K3 or K6) and dirt.backward.scatter.
"""

import collections

import torch

from . import (_cuda, backward, forward_blocks, grad_dense, grad_tables,
               prepass_fused)
from ..utils import profiling

TILE_H = 16
TILE_W = 16
CHUNK = 32
_BBOX = grad_tables._BBOX
FUSED = True

GRAD_REDUCE = _cuda.Kernel(
    "grad_reduce", "dirt_grad_reduce",
    [_cuda.ptr] * 6 + [_cuda.i32] * 25 + [_cuda.ptr],
    replaces=("dirt_tpu/ops/grad_blocks.py:147, "
              "dirt_tpu/ops/grad_blocks.py:176"),
    source="grad_reduce.cu")


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


def _layout_args(parts, channels):
    """The plane indices grad_math.cuh's GradLayout takes (-1: absent)."""
    _, L = grad_dense.plane_layout(parts, channels)
    return [L.get(name, -1) for name in (
        "ax", "ay", "px", "py", "bary_d", "face_d", "bary_pre", "face_pre",
        "grad")]


# --------------------------------------------------------------------------
# The launch shape of K3 and K6 (grad_math.cuh's reduce_run)
# --------------------------------------------------------------------------

VISIT_LIST = 1024      # tile ids of the list (grad_math.cuh's kVisitList)
MAX_LANES = 8          # pixel lanes per face
_SCRATCH = 64          # ints after the list (grad_math.cuh's kScratch)

ReduceShape = collections.namedtuple(
    "ReduceShape", "lanes depth group slot region staged smem")


def reduce_shape(chunk, staged, channels, want_col, optin):
    """The ReduceShape of a K3 or K6 launch on `chunk`-face blocks that
    stage `staged` floats a visit, under `optin` bytes of shared memory a
    block:
      lanes    P, the largest power of two <= min(MAX_LANES, 1024 //
               chunk): a block has chunk * P <= 1024 threads;
      group    colour channels a pass (_cuda.colour_group): the least
               of _cuda.GROUPS that covers `channels`, else the largest;
      depth    the ring's slots: 2 where two stacks fit `optin` beside the
               list, else 1;
      slot     floats a ring slot takes (`staged` rounded up to 4);
      region   floats of the ring, which the lane combine reuses for its
               (P / 2) * chunk * (9 + 3 * group) floats;
      smem     bytes of dynamic shared memory: region, then the visit
               list (VISIT_LIST ids, at least the threads) and scratch.
    Raises where no depth fits."""
    if chunk > 1024:
        raise ValueError(f"a {chunk}-face block exceeds 1024 threads (one "
                         "per face and pixel lane)")
    lanes = 1 << (min(MAX_LANES, 1024 // chunk).bit_length() - 1)
    group = _cuda.colour_group(channels, want_col)
    slot = _cdiv(staged, 4) * 4
    combine = (lanes // 2) * chunk * (9 + 3 * group)
    for depth in (2, 1):
        region = _cdiv(max(depth * slot, combine), 4) * 4
        smem = 4 * (region + VISIT_LIST + _SCRATCH)
        if smem <= optin:
            return ReduceShape(lanes, depth, group, slot, region, staged,
                               smem)
    raise ValueError(f"a plane stack of {staged} floats exceeds the "
                     f"{optin}-byte shared memory of a block")


def launch_shape(face_table, planes, channels, parts):
    """The ReduceShape K3 and K6 launch with on these CUDA inputs: the
    planes plane_layout(parts, channels) reads are staged."""
    staged = grad_dense.plane_layout(parts, channels)[0] * planes.shape[2]
    return reduce_shape(face_table.shape[1], staged, channels,
                        parts in ("all", "color"),
                        _cuda.shared_memory_optin(planes.device))


def _shape_args(face_table, planes, channels, parts):
    """launch_shape's arguments of the C entry points: the shape, whether
    the stacks take 16-byte copies (16-byte aligned, sizes in fours), and
    the shared memory's bytes."""
    s = launch_shape(face_table, planes, channels, parts)
    if s.staged > planes.shape[1] * planes.shape[2]:
        raise ValueError(f"planes hold {planes.shape[1]} planes, fewer than "
                         f"the {s.staged // planes.shape[2]} of "
                         f"plane_layout({parts!r}, {channels})")
    vec16 = (planes.data_ptr() % 16 == 0 and s.staged % 4 == 0
             and planes.shape[1] * planes.shape[2] % 4 == 0)
    return [s.group, s.lanes, s.depth, s.slot, s.region, s.staged,
            int(vec16), s.smem]


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
    shape = _shape_args(face_table, planes, channels, parts)
    d_out = grad_dense.d_out_for(parts, channels)
    out = torch.empty(runs, chunk, d_out, device=face_table.device)
    GRAD_REDUCE(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("planes", planes, torch.float32),
        _cuda.check("starts", starts, torch.int32, (runs,)),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("tile_ids", tile_ids, torch.int32),
        _cuda.check("out", out, torch.float32),
        runs, chunk, width_d, n_planes, pix, d_out, channels,
        int(parts in ("all", "position")), *_layout_args(parts, channels),
        *shape, _cuda.stream())
    return out


# --------------------------------------------------------------------------
# K6: the reductions on the slot schedule
# --------------------------------------------------------------------------

SLOT_GRAD_REDUCE = _cuda.Kernel(
    "slot_grad_reduce", "dirt_slot_grad_reduce",
    [_cuda.ptr] * 6 + [_cuda.i32] * 26 + [_cuda.ptr],
    replaces="dirt_tpu/ops/grad_blocks.py:120", source="slot_grad.cu")


def slot_grad_reduce_plain(face_table, planes, slot_run, slot_item, slot_dma,
                           channels, parts):
    """Per-face sums [B*NB, chunk, d_out] of the slot schedule: face block
    r adds grad_dense._chunk_sums over the tiles of its live slots
    (slot_run == r, slot_item >= 0) in slot order; a block without one
    keeps zeros."""
    starts, counts, tile_ids = forward_blocks.slot_runs(
        slot_run, slot_item, slot_dma, face_table.shape[0])
    return grad_reduce_plain(face_table, planes, starts, counts, tile_ids,
                             channels, parts)


def slot_grad_reduce(face_table, planes, slot_run, slot_item, slot_dma,
                     channels, parts):
    """K6 wrapper: slot_grad_reduce_plain's rows, by the CUDA kernel for
    CUDA tensors and by the plain version for CPU tensors.

    face_table [B*NB, chunk, _DF] f32; planes [B*T, NP, PIX] f32 in
    plane_layout(parts, channels) order; slot_run [B*S] (batch-folded
    block, non-decreasing), slot_item [B*S] (per-image tile, -1 for no-op
    slots) and slot_dma [B*S] (batch-folded tile) int32."""
    if not _cuda.on_cuda(face_table, planes, slot_run, slot_item, slot_dma):
        return slot_grad_reduce_plain(face_table, planes, slot_run,
                                      slot_item, slot_dma, channels, parts)
    runs, chunk, width_d = face_table.shape
    slots = slot_run.shape[0]
    n_planes, pix = planes.shape[1], planes.shape[2]
    shape = _shape_args(face_table, planes, channels, parts)
    d_out = grad_dense.d_out_for(parts, channels)
    out = torch.empty(runs, chunk, d_out, device=face_table.device)
    SLOT_GRAD_REDUCE(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("planes", planes, torch.float32),
        _cuda.check("slot_run", slot_run, torch.int32, (slots,)),
        _cuda.check("slot_item", slot_item, torch.int32, (slots,)),
        _cuda.check("slot_dma", slot_dma, torch.int32, (slots,)),
        _cuda.check("out", out, torch.float32),
        runs, slots, chunk, width_d, n_planes, pix, d_out, channels,
        int(parts in ("all", "position")), *_layout_args(parts, channels),
        *shape, _cuda.stream())
    return out


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

# dilate=1: the gradient support is coverage dilated one pixel.  Runs are
# face blocks, items tiles; no visits counter.
GRADIENT = forward_blocks.Pass("backward", _BBOX, 12, 1, True, None)


def pack(vertices, faces, height, width, tile_h, tile_w, chunk, slots=False):
    """The gradient schedule for a batch (forward_blocks.schedule):
    (face_table [B*NB, chunk, _DF], starts [B*NB], counts [B*NB], tile_ids
    [B*S], row_face [B, NB*chunk]), or with `slots` (face_table, slot_run
    [B*S], slot_item [B*S], slot_dma [B*S], row_face); row_face maps table
    rows to faces.  The dilated hits make this schedule a superset of the
    forward's, so it can truncate visits (backward.dropped) where the
    forward's truncates none."""
    face_table, runs, _, row_face = forward_blocks.schedule(
        GRADIENT, vertices, faces, None, height, width, tile_h, tile_w,
        chunk, slots)
    return (face_table, *runs, row_face)


def rasterise_grad_batch(vertices, faces, pixels, grad_pixels, aux,
                         parts="all", color_cotangent=None,
                         tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK):
    """Block-binned face-major gradient assembly on the CSR runs (K3) or,
    with FUSED off, the slot schedule (K6); the contract of
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
        return grad_dense.no_face_grads(vertices, grad_pixels, cot)
    with profiling.span("dirt.backward.prepass", pixels):
        planes, grad_background, dilated = prepass_fused.gradient_planes(
            pixels, grad_pixels, aux, parts, color_cotangent, tile_h,
            tile_w)

    face_table, *runs, row_face = pack(vertices, faces, height, width,
                                       tile_h, tile_w, chunk,
                                       slots=not FUSED)
    reduce = grad_reduce if FUSED else slot_grad_reduce
    with profiling.span("dirt.backward.reduce", planes):
        face_grads = reduce(face_table, planes, *runs, channels, parts)

    # Rows map 1:1 to faces in table order; padded tail rows reduce to
    # zeros and scatter harmlessly into vertex 0.
    with profiling.span("dirt.backward.scatter", face_grads):
        num_blocks = _cdiv(num_faces, chunk)
        d_out = grad_dense.d_out_for(parts, channels)
        face_grads = face_grads.reshape(batch, num_blocks * chunk, 3,
                                        d_out // 3)
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
