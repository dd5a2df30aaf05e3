"""Block-binned (CSR) forward rasteriser: the CUDA main path (PyTorch port
of dirt_tpu/ops/forward_blocks.py).

The schedule is the JAX package's fused-CSR one:

  * faces are grouped into BLOCKS of `chunk` rows of the face table
    (ops/forward_pallas.py layout), after a Morton sort of the rows by
    their bbox-centre tile (spatial_order) so blocks are spatially
    coherent whatever the draw order (face_table, kernel K13 on CUDA:
    each face's Morton key, their stable argsort, and the table's rows
    written from the vertices straight into that order; the CPU runs the
    plain table, spatial_order and a gather, face_table_plain);
  * the hit test (hit_matrix, kernel K4 on CUDA) keeps a (tile, block)
    pair when some member face's bbox overlaps the tile and its
    edge-sign regions can reach it (the conservative half-plane cull).
    K4 decides the [B, T, NB] block hits itself: a block's faces bound a
    window of tiles their bbox compares can pass (hit_windows), each
    member face is tested on the window's tiles, a warp vote ORs the
    block's tests, and every (tile, block) outside the window is a miss
    left in the zero-filled output, so its work and traffic scale with
    the tiles the faces reach and the 1-byte output, not with T x F (the
    CPU runs the plain [B, T, F] plane and its `any`, hit_blocks_plain);
  * build_runs lays the hits out as CSR runs: per tile, the live block
    ids in ascending order, under a static slot budget whose overflow is
    counted in RasterAux.dropped (kernel K12 on CUDA: a count, the
    cumsum of the counts, and the ids stored from the starts; the CPU
    runs the plain argsort and scatter, build_runs_plain);
  * the sweep (raster_sweep, kernel K1 on CUDA) walks each tile's run and
    keeps the lexicographic (depth, original index) winner per pixel; K1
    cuts a run of more than SWEEP_PIECE visits into pieces, a thread
    block each, and merges their winners in piece order (sweep_plan);
  * forward_dense.finalize does the one division and the aux assembly.

Two further schedules compute the same state bit for bit:

  * the resident-table sweep (resident_sweep, kernel K5 on CUDA): when the
    image's face table fits the RESIDENT_MB budget, a thread block with a
    visit in its group of RESIDENT_TILES tiles stages the table in shared
    memory once and reads each visit's block by index;
  * the slot schedule (FUSED off): build_slots lists one slot per (tile,
    block) hit plus one mandatory slot per tile, and slot_sweep (kernel
    K5b on CUDA) walks each tile's slots.  Tiles whose slots the static
    budget cut are background.

Switches, module constants that tests set (the schedules they choose
compute the same state bit for bit):

  * FUSED (default on): the CSR runs; off selects the slot schedule;
  * RESIDENT_MB (default -1 = never): the resident-table budget in MB,
    0 = auto = the device's opt-in shared memory per block; a positive
    value is capped by that limit;
  * SPATIAL (default on): the Morton sort of the table rows, in both
    passes' schedules (schedule);
  * EDGE_CULL (default on): the half-plane refinement of every block hit
    test (hit_matrix).

Tile shape and block size are parameters.  The defaults are this port's
GPU shape for every schedule (16x16-pixel tiles, one thread per pixel;
32-face blocks); the tests call the functions at the JAX package's shapes
(4x128 tiles and 64-face blocks fused, 32x128 and 128 on slots) to
compare with it bitwise.

Both passes build their schedule in one function, schedule, which takes
the pass (Pass: FORWARD here, grad_blocks.GRADIENT) as data.  Under a
torch.profiler session each stage records a span (utils/profiling):
dirt.forward.table (K13: face table, Morton sort; counters
forward.clipped and forward.culled, the faces whose bbox the near/far clip
gave and those it emptied, clip_counts), dirt.forward.hits (K4; counter
forward.hit_window, the windows' tiles), dirt.forward.runs (the schedule,
K12; counters forward.visits, forward.dropped and forward.budget, the
fullest image's visits, kept and dropped, in BUDGET_UNIT of its slot
budget), dirt.forward.sweep (K1; counter forward.chain, the most visits
one of its blocks sweeps, sweep_chain) and dirt.forward.finalize.  The
clip, budget and chain counters are computed when the records are read,
outside the steps.
"""

import collections
import functools
import math
import os

import torch

from . import (_cuda, forward_dense, forward_pallas, geometry, grad_tables,
               reference)
from ..utils import profiling

TILE_H = 16
TILE_W = 16
CHUNK = 32
_BBOX = (20, 21, 22, 23)
FUSED = True
RESIDENT_MB = -1.0
SPATIAL = True
EDGE_CULL = True


def _cdiv(a, b):
    return -(-a // b)


# The <pass>.budget counters' unit: parts per million of the slot budget.
BUDGET_UNIT = 10 ** 6


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


_EMPTY_KEY = torch.iinfo(torch.int32).max


def spatial_keys(r0, r1, c0, c1, tile_h, tile_w):
    """The int32 Morton code of each pixel bbox's centre tile (int32
    bounds); _EMPTY_KEY for an empty bbox (r1 < r0)."""
    empty = r1 < r0
    ty = ((r0 + r1) // 2).clamp(min=0) // tile_h
    tx = ((c0 + c1) // 2).clamp(min=0) // tile_w
    key = _morton(ty.clamp(0, (1 << 15) - 1), tx.clamp(0, (1 << 15) - 1))
    return torch.where(empty, _EMPTY_KEY, key)


def spatial_order(face_data, bbox_cols, tile_h, tile_w):
    """[B, F] stable permutation of the table rows by the Morton code of
    each face's bbox-centre tile; empty bboxes sort last, ties keep draw
    order."""
    bbox = (face_data[..., c].to(torch.int32) for c in bbox_cols)
    key = spatial_keys(*bbox, tile_h, tile_w)
    return torch.argsort(key, dim=-1, stable=True).to(torch.int32)


def _run_bounds(n, num_slots):
    """(starts, counts, dropped) of runs of n [B, R] live items, per
    image, under a static budget of `num_slots`: the exclusive prefix of
    n and the runs' lengths, both clamped to the budget, and the items
    past it."""
    total = n.cumsum(dim=-1, dtype=torch.int32)
    starts = (total - n).clamp(max=num_slots)
    counts = total.clamp(max=num_slots) - starts
    dropped = (n.sum(dim=-1, dtype=torch.int32) - num_slots).clamp(min=0)
    return starts, counts, dropped


def build_runs_plain(hit, num_slots):
    """CSR schedule from the [B, R, I] bool hit matrix: (starts [B, R],
    counts [B, R], item_ids [B, S], dropped [B]) int32, per image.  Run
    r's live items (ascending) occupy item_ids[starts[r]:starts[r] +
    counts[r]]; truncation by the static budget clamps the last runs and
    is counted in `dropped`; the slots past the image's live items are
    zero."""
    batch, num_runs, num_items = hit.shape
    n = hit.sum(dim=-1, dtype=torch.int32)                   # [B, R]
    starts, counts, dropped = _run_bounds(n, num_slots)
    j = torch.arange(num_items, dtype=torch.int32, device=hit.device)
    order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
    pos = torch.where(j < n[..., None], starts[..., None] + j, num_slots)
    pos = pos.clamp(max=num_slots).reshape(batch, -1).long()
    item_ids = torch.zeros(batch, num_slots + 1, dtype=torch.int32,
                           device=hit.device)
    item_ids.scatter_(1, pos, order.reshape(batch, -1).to(torch.int32))
    return starts, counts, item_ids[:, :num_slots].contiguous(), dropped


# K12 (csrc/build_runs.cu): counts each run's live items, then stores
# them from the starts the cumsum gives; a launch each (BUILD_RUNS.launches
# counts two a call).
BUILD_RUNS = _cuda.Kernel(
    "build_runs", "dirt_build_runs",
    [_cuda.ptr] * 5 + [_cuda.i32] * 3 + [_cuda.i64] * 3 + [_cuda.i32] * 4
    + [_cuda.ptr],
    replaces=None, source="build_runs.cu")
# The bytes a K12 lane loads at once where whole words line up.
RUNS_WORD = 4


def runs_layout(hit):
    """K12's walk of the [B, R, I] view `hit`, from its strides: (lanes on
    items, width).  The lanes read along the axis of the smaller stride,
    the items (the forward's rows) or the runs (the gradient's transposed
    view); RUNS_WORD bytes a lane where that axis is contiguous, its
    length, the other strides and the address are multiples of
    RUNS_WORD, else 1."""
    _, num_runs, num_items = hit.shape
    sb, sr, si = hit.stride()
    on_items = si <= sr
    along, across, length = ((si, sr, num_items) if on_items
                             else (sr, si, num_runs))
    whole = (along == 1 and across % RUNS_WORD == 0 and sb % RUNS_WORD == 0
             and length % RUNS_WORD == 0
             and hit.data_ptr() % RUNS_WORD == 0)
    return on_items, RUNS_WORD if whole else 1


def build_runs(hit, num_slots):
    """K12 wrapper: build_runs_plain's schedule, bit for bit, by the CUDA
    kernel for CUDA tensors and by the plain version for CPU tensors.
    `hit` is any strided [B, R, I] bool view (the gradient pack's
    transposed hits are read in place, runs_layout)."""
    if hit.dtype != torch.bool or hit.dim() != 3:
        raise ValueError(f"build_runs takes [B, R, I] bool hits, got "
                         f"{hit.dtype} of shape {tuple(hit.shape)}")
    if not _cuda.on_cuda(hit):
        return build_runs_plain(hit, num_slots)
    batch, num_runs, num_items = hit.shape
    n = torch.empty(batch, num_runs, dtype=torch.int32, device=hit.device)
    item_ids = torch.zeros(batch, num_slots, dtype=torch.int32,
                           device=hit.device)
    shape = (batch, num_runs, num_items, *hit.stride(), num_slots,
             *runs_layout(hit))
    BUILD_RUNS(hit.data_ptr(), _cuda.check("n", n, torch.int32), None, None,
               _cuda.check("item_ids", item_ids, torch.int32), *shape, 0,
               _cuda.stream())
    starts, counts, dropped = _run_bounds(n, num_slots)
    BUILD_RUNS(hit.data_ptr(), n.data_ptr(),
               _cuda.check("starts", starts, torch.int32, n.shape),
               _cuda.check("counts", counts, torch.int32, n.shape),
               item_ids.data_ptr(), *shape, 1, _cuda.stream())
    return starts, counts, item_ids, dropped


def build_slots(hit, num_slots):
    """Slot schedule from the [B, R, I] bool hit matrix: (slot_run [B, S],
    slot_item [B, S], slot_dma [B, S], dropped [B]) int32, per image.

    Consecutive slots of one run hold its hit items, ascending; a run
    without hits still gets one slot with item -1, and the filler tail
    repeats the last run with item -1.  slot_dma forward-fills the items
    (0 before the first live slot).  `dropped` counts the slots, mandatory
    ones included, that the static budget could not hold."""
    batch, num_runs, num_items = hit.shape
    device = hit.device
    order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
    n = hit.sum(dim=-1, dtype=torch.int32)                   # [B, R]
    m = n.clamp(min=1)                                       # >= 1 slot
    start = m.cumsum(dim=-1, dtype=torch.int32) - m
    j = torch.arange(num_items, dtype=torch.int32, device=device)
    pos = torch.where(j < m[..., None], start[..., None] + j, num_slots)
    pos = pos.clamp(max=num_slots).reshape(batch, -1).long()
    run_of = torch.arange(num_runs, dtype=torch.int32,
                          device=device)[:, None].expand(-1, num_items)
    item_of = torch.where(j < n[..., None], order.to(torch.int32), -1)
    slot_run = torch.zeros(batch, num_slots + 1, dtype=torch.int32,
                           device=device)
    slot_run.scatter_(1, pos, run_of.reshape(1, -1).expand(batch, -1))
    slot_item = torch.full((batch, num_slots + 1), -1, dtype=torch.int32,
                           device=device)
    slot_item.scatter_(1, pos, item_of.reshape(batch, -1))
    slot_run, slot_item = slot_run[:, :num_slots], slot_item[:, :num_slots]
    # Filler tail: the last run again, with no item.
    total = m.sum(dim=-1, dtype=torch.int32)
    kept = total.clamp(max=num_slots)
    last_run = torch.where(kept > 0, slot_run.gather(
        1, (kept - 1).clamp(min=0).long()[:, None])[:, 0], 0)
    idx = torch.arange(num_slots, dtype=torch.int32, device=device)
    tail = idx >= kept[:, None]
    slot_run = torch.where(tail, last_run[:, None], slot_run)
    slot_item = torch.where(tail, -1, slot_item)
    last_live = torch.cummax(torch.where(slot_item >= 0, idx, -1),
                             dim=-1).values
    slot_dma = torch.where(last_live >= 0, slot_item.gather(
        1, last_live.clamp(min=0).long()), 0)
    dropped = (total - num_slots).clamp(min=0)
    return (slot_run.contiguous(), slot_item.contiguous(),
            slot_dma.contiguous(), dropped)


def slot_runs(slot_run, slot_item, slot_dma, num_runs):
    """The CSR form (starts, counts, item_ids [L]) of a batch-folded slot
    list: run r's live slots (item >= 0), in slot order, with the
    batch-folded items of slot_dma."""
    live = slot_item >= 0
    counts = torch.bincount(slot_run[live].long(), minlength=num_runs)
    starts = counts.cumsum(0) - counts
    return (starts.to(torch.int32), counts.to(torch.int32),
            slot_dma[live].contiguous())


def group_for(num_tiles):
    """dirt_tpu's tiles per grid step of its resident sweep, mirrored: the
    largest of 8, 4 and 2 that divides the tile count (groups never
    straddle images), else 1.  K5 no longer uses it: its blocks take
    RESIDENT_TILES tiles."""
    for g in (8, 4, 2):
        if num_tiles % g == 0:
            return g
    return 1


def resident_budget_bytes(limit):
    """The resident-table budget in bytes under RESIDENT_MB: 0 for -1
    (never), `limit` for 0 (auto), else the MB value capped by `limit`.
    `limit` is the device's opt-in shared memory per block, or None for
    CPU tensors, whose plain version has no such bound (auto then admits
    every table)."""
    if RESIDENT_MB < 0:
        return 0
    if RESIDENT_MB == 0:
        return math.inf if limit is None else limit
    want = int(RESIDENT_MB * 1024 * 1024)
    return want if limit is None else min(want, limit)


def takes_resident(face_table, num_images):
    """True when the per-image table of `face_table` ([B*NB, chunk, D])
    fits resident_budget_bytes on its device (queried for CUDA)."""
    if RESIDENT_MB < 0:
        return False
    table_bytes = face_table[0].numel() * 4 * (face_table.shape[0]
                                               // num_images)
    limit = (_cuda.shared_memory_optin(face_table.device)
             if _cuda.on_cuda(face_table) else None)
    return table_bytes <= resident_budget_bytes(limit)


# --------------------------------------------------------------------------
# K13: the face tables
# --------------------------------------------------------------------------

# K13 (csrc/face_table.cu): a keys launch (the Morton keys the stable
# argsort orders) and a rows launch (the table written in that order); its
# launch count is two a table.
FACE_TABLE = _cuda.Kernel(
    "face_table", "dirt_face_table",
    [_cuda.ptr] * 6 + [_cuda.i32] * 9 + [_cuda.f32] * 2 + [_cuda.i32] * 2
    + [_cuda.ptr],
    replaces=None, source="face_table.cu")

# A face table's layout as K13 takes it: the plain builder of the unsorted
# table (vertices, faces, attrs, height, width, pad_rows), the bbox columns,
# the face-index column and the bbox's widening.  The forward's
# (forward_pallas._face_table, 27 + 3C columns) goes with vertex
# attributes, the gradient's (grad_tables._grad_face_table, 21) with none.
TableLayout = collections.namedtuple("TableLayout", "build bbox face widen")
_FORWARD_TABLE = TableLayout(
    lambda v, f, a, h, w, pad: forward_pallas._face_table(v, a, f, h, w, pad),
    _BBOX, 19, 0)
_GRADIENT_TABLE = TableLayout(
    lambda v, f, a, h, w, pad: grad_tables._grad_face_table(v, f, h, w, pad),
    grad_tables._BBOX, 4, 1)


def table_layout(attrs):
    """The TableLayout of the table of vertex attributes `attrs` (None:
    the gradient's)."""
    return _GRADIENT_TABLE if attrs is None else _FORWARD_TABLE


def clip_counts(vertices, faces, height, width):
    """[B, 2] int64: each image's valid faces whose pixel bbox came from the
    near/far clip (forward_pallas.CLIPPED) and those the clip emptied
    (CULLED), by the plain rule, which K13's bboxes equal bit for bit."""
    valid = geometry.face_setup(vertices, faces).valid
    clip = forward_pallas.clip_status(geometry.gather_corners(vertices, faces),
                                      height, width)
    return torch.stack([(valid & (clip == forward_pallas.CLIPPED)).sum(-1),
                        (valid & (clip == forward_pallas.CULLED)).sum(-1)],
                       dim=-1)


def face_table_plain(vertices, faces, attrs, height, width, rows, tile=None):
    """A pass's face table by the plain path: the unsorted table of
    table_layout(attrs), padded to `rows`, sorted by spatial_order where
    `tile` = (tile_h, tile_w) is given.  Returns (table [B, rows, D],
    order [B, rows] int32, the unsorted row each row came from)."""
    layout = table_layout(attrs)
    table = layout.build(vertices, faces, attrs, height, width,
                         rows - faces.shape[1])
    if tile is None:
        order = torch.arange(rows, dtype=torch.int32,
                             device=vertices.device).expand(faces.shape[0], -1)
        return table, order
    order = spatial_order(table, layout.bbox, *tile)
    return (torch.take_along_dim(table, order[..., None].long(),
                                 dim=1).contiguous(), order)


def face_keys_plain(vertices, faces, rows, height, width, widen, tile_h,
                    tile_w):
    """[B, rows] int32: K13's keys, from the vertices: spatial_keys of each
    face's pixel bbox (forward_pallas.pixel_bbox widened by `widen`, the
    table's bbox columns), _EMPTY_KEY for the rows past the faces."""
    valid = geometry.face_setup(vertices, faces).valid
    bbox = forward_pallas.pixel_bbox(geometry.gather_corners(vertices, faces),
                                     valid, height, width, widen)
    keys = spatial_keys(*bbox, tile_h, tile_w)
    pad = torch.full((faces.shape[0], rows - faces.shape[1]), _EMPTY_KEY,
                     dtype=torch.int32, device=keys.device)
    return torch.cat([keys, pad], dim=1)


def face_rows_plain(vertices, faces, attrs, rows, height, width, order=None):
    """[B, rows, D] float32: K13's rows, set up row by row: row j of image
    b is the table_layout(attrs) row of face order[b, j] (order [B, rows]
    int32; j where None), or the pad row where that is past the faces."""
    layout = table_layout(attrs)
    batch, num_faces = faces.shape[:2]
    if order is None:
        order = torch.arange(rows, dtype=torch.int32,
                             device=faces.device).expand(batch, -1)
    pad = layout.build(vertices, faces[:, :0], attrs, height, width, 1)
    real = (order < num_faces)[..., None]
    picked = torch.take_along_dim(
        faces, torch.where(real, order[..., None], 0).long(), dim=1)
    table = layout.build(vertices, picked, attrs, height, width, 0)
    table[..., layout.face] = order.float()
    return torch.where(real, table, pad)


def _face_launch(vertices, faces, attrs, rows, height, width, widen,
                 order=None, keys=None, out=None, tile=(1, 1)):
    """One K13 launch on checked inputs: the keys launch into `keys`
    [B, rows] int32, else the rows launch into `out` [B, rows, D]."""
    batch, num_vertices = vertices.shape[:2]
    num_faces = faces.shape[1]
    if not 0 <= num_faces <= rows:
        raise ValueError(f"K13 pads {num_faces} faces to {rows} rows")
    channels = 0 if attrs is None else attrs.shape[-1]
    shape = (batch, rows)
    FACE_TABLE(
        _cuda.check("vertices", vertices, torch.float32,
                    (batch, num_vertices, 4)),
        _cuda.check("faces", faces, torch.int32, (batch, num_faces, 3)),
        None if attrs is None else _cuda.check(
            "attrs", attrs, torch.float32, (batch, num_vertices, channels)),
        None if order is None else _cuda.check("order", order, torch.int32,
                                               shape),
        None if keys is None else _cuda.check("keys", keys, torch.int32,
                                              shape),
        None if out is None else _cuda.check("out", out, torch.float32),
        batch, num_vertices, num_faces, rows, channels, int(attrs is None),
        widen, height, width, width / 2.0, height / 2.0, *tile,
        _cuda.stream())


def face_keys(vertices, faces, rows, height, width, widen, tile_h, tile_w):
    """K13's keys launch: face_keys_plain's keys, by the CUDA kernel for
    CUDA tensors and by the plain version for CPU tensors."""
    if not _cuda.on_cuda(vertices, faces):
        return face_keys_plain(vertices, faces, rows, height, width, widen,
                               tile_h, tile_w)
    keys = torch.empty(faces.shape[0], rows, dtype=torch.int32,
                       device=faces.device)
    _face_launch(vertices, faces, None, rows, height, width, widen,
                 keys=keys, tile=(tile_h, tile_w))
    return keys


def face_rows(vertices, faces, attrs, rows, height, width, order=None):
    """K13's rows launch: face_rows_plain's rows, by the CUDA kernel for
    CUDA tensors and by the plain version for CPU tensors."""
    tensors = [t for t in (vertices, faces, attrs, order) if t is not None]
    if not _cuda.on_cuda(*tensors):
        return face_rows_plain(vertices, faces, attrs, rows, height, width,
                               order)
    width_d = (grad_tables._DF if attrs is None
               else forward_pallas._BASE + 3 * attrs.shape[-1])
    out = torch.empty(faces.shape[0], rows, width_d, device=faces.device)
    _face_launch(vertices, faces, attrs, rows, height, width,
                 table_layout(attrs).widen, order=order, out=out)
    return out


def face_table(vertices, faces, attrs, height, width, rows, tile=None):
    """A pass's face table, face_table_plain's bit for bit: on CUDA K13's
    keys, their stable argsort and K13's rows in that order (the rows
    alone, in face order, where `tile` is None); the plain path on the
    CPU."""
    if not _cuda.on_cuda(vertices, faces):
        return face_table_plain(vertices, faces, attrs, height, width, rows,
                                tile)
    vertices = vertices.float().contiguous()
    faces = faces.to(torch.int32).contiguous()
    if attrs is not None:
        attrs = attrs.float().contiguous()
    order = None
    if tile is not None:
        keys = face_keys(vertices, faces, rows, height, width,
                         table_layout(attrs).widen, *tile)
        order = torch.argsort(keys, dim=-1, stable=True).to(torch.int32)
    table = face_rows(vertices, faces, attrs, rows, height, width, order)
    if order is None:
        order = torch.arange(rows, dtype=torch.int32,
                             device=faces.device).expand(faces.shape[0], -1)
    return table, order


# --------------------------------------------------------------------------
# K4: the block hits
# --------------------------------------------------------------------------

HIT_PLANE = _cuda.Kernel(
    "hit_plane", "dirt_hit_blocks",
    [_cuda.ptr] * 3 + [_cuda.i32] * 15 + [_cuda.f32] * 2 + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:322", source="hit_plane.cu")

# K4's launch shape, which the kernel sizes itself: thread blocks of
# HIT_THREADS threads, a face each, where a block's faces fit a warp
# (chunk <= 32), else of `chunk` threads, up to HIT_MAX_CHUNK; the chunk
# is a power of two (hit_plane.cu's kHitThreads and kMaxChunk; the CPU
# tests hold its grid to visiting each (image, block) once).
HIT_THREADS = 128
HIT_MAX_CHUNK = 1024


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


def tile_range(lo, hi, tile, tiles):
    """([...] lo, [...] hi) float32: the tiles along one axis whose two
    bbox compares a face's pixel bounds [lo, hi] can pass, widened by one
    tile on each side and clamped to [0, tiles - 1]; every tile where a
    bound is not finite; none (lo > hi) where none can pass.  hit_plane.cu's
    tile_range, operation for operation."""
    finite = torch.isfinite(lo) & torch.isfinite(hi)
    a = (torch.ceil((lo - (tile - 1)) / tile) - 1.0).clamp(min=0.0)
    b = (torch.floor(hi / tile) + 1.0).clamp(max=float(tiles - 1))
    return (torch.where(finite, a, 0.0),
            torch.where(finite, b, float(tiles - 1)))


def hit_windows(face_data, bbox_cols, num_blocks, chunk, tiles_y, tiles_x,
                tile_h, tile_w):
    """[B, NB] int32: the tiles of each block's window in K4, the bounding
    rectangle of its faces' tile_range rows and columns (0 where no face
    can pass a bbox compare)."""
    r0, r1, c0, c1 = (face_data[..., c] for c in bbox_cols)
    ry0, ry1 = tile_range(r0, r1, tile_h, tiles_y)
    cx0, cx1 = tile_range(c0, c1, tile_w, tiles_x)
    reach = (ry0 <= ry1) & (cx0 <= cx1)
    block = lambda v, fill: torch.where(reach, v, fill).reshape(
        *v.shape[:-1], num_blocks, chunk)
    rows = (block(ry1, -1.0).amax(-1) - block(ry0, float(tiles_y)).amin(-1)
            + 1).clamp(min=0)
    cols = (block(cx1, -1.0).amax(-1) - block(cx0, float(tiles_x)).amin(-1)
            + 1).clamp(min=0)
    return (rows * cols).to(torch.int32)


def hit_blocks_plain(face_data, bbox_cols, num_blocks, chunk, tiles_y,
                     tiles_x, tile_h, tile_w, edge_cols, height, width,
                     dilate, window=None):
    """[B, T, NB] bool: a block hits a tile iff some member face is kept
    by hit_plane_plain; where `window` ([B, NB] int32) is given, it gets
    hit_windows' tile counts."""
    if window is not None:
        window.copy_(hit_windows(face_data, bbox_cols, num_blocks, chunk,
                                 tiles_y, tiles_x, tile_h, tile_w))
    keep = hit_plane_plain(face_data, bbox_cols, tiles_y, tiles_x, tile_h,
                           tile_w, edge_cols, height, width, dilate)
    return (keep > 0.5).reshape(face_data.shape[0], tiles_y * tiles_x,
                                num_blocks, chunk).any(dim=-1)


def hit_blocks(face_data, bbox_cols, num_blocks, chunk, tiles_y, tiles_x,
               tile_h, tile_w, edge_cols, height, width, dilate,
               window=None):
    """K4 wrapper: hit_blocks_plain's block hits (and window counts), by
    the CUDA kernel for CUDA tensors and by the plain version for CPU
    tensors.  The table holds num_blocks * chunk rows; on CUDA the chunk
    is a power of two up to HIT_MAX_CHUNK."""
    if not _cuda.on_cuda(face_data):
        return hit_blocks_plain(face_data, bbox_cols, num_blocks, chunk,
                                tiles_y, tiles_x, tile_h, tile_w, edge_cols,
                                height, width, dilate, window)
    batch, num_faces, width_d = face_data.shape
    if not (0 < chunk <= HIT_MAX_CHUNK and chunk & (chunk - 1) == 0):
        raise ValueError(f"K4 takes a chunk that is a power of two up to "
                         f"{HIT_MAX_CHUNK}, got {chunk}")
    if num_faces != num_blocks * chunk:
        raise ValueError(f"K4 takes num_blocks * chunk = "
                         f"{num_blocks * chunk} table rows, got {num_faces}")
    num_tiles = tiles_y * tiles_x
    hit = torch.zeros(batch, num_tiles, num_blocks, dtype=torch.bool,
                      device=face_data.device)
    HIT_PLANE(
        _cuda.check("face_data", face_data, torch.float32),
        _cuda.check("hit", hit, torch.bool),
        None if window is None else _cuda.check(
            "window", window, torch.int32, (batch, num_blocks)),
        batch, num_faces, width_d, num_blocks, chunk, tiles_y, tiles_x,
        tile_h, tile_w, *bbox_cols, -1 if edge_cols is None else edge_cols,
        dilate, 2.0 / width, 2.0 / height, _cuda.stream())
    return hit


def hit_matrix(face_data, bbox_cols, num_blocks, chunk,
               tiles_y, tiles_x, tile_h, tile_w,
               edge_cols=None, height=None, width=None, dilate=0,
               counter=None):
    """[B, T, NB] bool: block hits tile iff some member face passes the
    hit test (bbox overlap, plus, when EDGE_CULL is on, the half-plane
    cull with `edge_cols`, the column of the first of 9 consecutive edge
    coefficients): K4.  While a profiler session records, the windows'
    tile counts go to the counter named `counter`, where one is given."""
    if not EDGE_CULL:
        edge_cols = None
    window = None
    if counter is not None and profiling.recording():
        window = torch.empty(face_data.shape[0], num_blocks,
                             dtype=torch.int32, device=face_data.device)
    hit = hit_blocks(face_data, bbox_cols, num_blocks, chunk, tiles_y,
                     tiles_x, tile_h, tile_w, edge_cols, height, width,
                     dilate, window)
    if window is not None:
        profiling.count(counter, window)
    return hit


# --------------------------------------------------------------------------
# K1: the sweep
# --------------------------------------------------------------------------

# K1 (csrc/raster_sweep.cu): where a run can be split, a plan launch (the
# extra pieces' slots, the tickets zeroed) before the sweep, in one call
# of the entry point (RASTER_SWEEP.launches counts one a call).
RASTER_SWEEP = _cuda.Kernel(
    "raster_sweep", "dirt_raster_sweep",
    [_cuda.ptr] * 9 + [_cuda.i32] * 10 + [_cuda.f32] * 2 + [_cuda.i32] * 8
    + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:576",
    source="raster_sweep.cu")

# The run walk of K1, K5b, K5 and K8 (sweep_math.cuh's sweep_run): a block
# is S face groups of one thread a pixel; S is the largest power of two up
# to SWEEP_GROUPS that keeps the block within SWEEP_THREADS, and the kernels'
# launch bound holds SWEEP_BLOCKS such blocks on an SM (a bigger tile
# takes one group, up to 1024 threads).  A face stages FACE_FLOATS
# floats.  The constants mirror the kernels' kSweepGroups, kSweepThreads,
# kSweepBlocks, kFaceFloats and kSweepScratch.
SWEEP_GROUPS = 2
SWEEP_THREADS = 512
SWEEP_BLOCKS = 3
FACE_FLOATS = 24
_SWEEP_SCRATCH = 64
# K5b's search reads a window of SLOT_WINDOW slots into the visit list
# (slots.cuh's kWindow), so the list holds at least that many.
SLOT_WINDOW = 96
# Shared memory of one H100 SM (cudaDevAttrMaxSharedMemoryPerMultiprocessor)
# and the threads it holds: a block's staging takes the share of its
# threads, so shared memory does not cut the blocks an SM runs at once.
SM_SHARED_BYTES = 233472
SM_THREADS = 2048

# The visits a K1 block sweeps at most (raster_sweep.cu's kSweepPiece): a
# longer run is cut into pieces of consecutive visits, a block each, whose
# partial winners the run's last block merges in piece order; the value
# by trials of 1 to 256 at the benchmark's 32 x 512^2, from outside and
# inside the cylinder (PERF.md).
SWEEP_PIECE = 32

SweepShape = collections.namedtuple(
    "SweepShape", "groups threads cap region list smem")


@functools.lru_cache(maxsize=None)
def sweep_shape(pix, chunk, optin):
    """The SweepShape of a K1 or K5b launch on tiles of `pix` pixels and
    `chunk`-face blocks (K8: chunk 1, a face list), under `optin` bytes of
    shared memory a block:
      groups   S face groups, the largest power of two <= SWEEP_GROUPS
               with S * pix <= SWEEP_THREADS, else 1 (a tile of more
               than SWEEP_THREADS pixels takes the kernels' 1024-thread
               instantiation);
      threads  the block's threads, S * pix;
      cap      visits the staging area holds: the block's share of an
               SM's shared memory (threads / SM_THREADS of it, less the
               1 KB the SM reserves a block), less the list and scratch,
               over chunk * FACE_FLOATS floats a visit, at least 2;
      region   floats of the staging area, which the group combine reuses
               for (S - 1) * pix winners of 7 words;
      list     ints of the visit list: the threads (K5b's compaction
               takes a window of one slot a thread), at least SLOT_WINDOW;
      smem     bytes of dynamic shared memory: region, list, scratch.
    Raises where the tile exceeds 1024 pixels, the block holds fewer
    than one warp, or the shape exceeds `optin`."""
    if pix > 1024:
        raise ValueError(f"the sweep runs one thread a pixel: a {pix}-pixel "
                         f"tile exceeds a block's 1024 threads")
    groups = SWEEP_GROUPS
    while groups > 1 and groups * pix > SWEEP_THREADS:
        groups //= 2
    threads = groups * pix
    if threads < 32:
        raise ValueError(f"a {pix}-pixel tile gives a block of {threads} "
                         f"threads, under one warp")
    visit = chunk * FACE_FLOATS
    budget = SM_SHARED_BYTES * threads // SM_THREADS - 1024
    listed = max(threads, SLOT_WINDOW)
    cap = max(2, (budget // 4 - listed - _SWEEP_SCRATCH) // visit)
    combine = (groups - 1) * pix * 7
    region = _cdiv(max(cap * visit, combine), 4) * 4
    smem = 4 * (region + listed + _SWEEP_SCRATCH)
    if smem > optin:
        raise ValueError(f"two visits of {chunk} faces exceed the "
                         f"{optin}-byte shared memory of a block")
    return SweepShape(groups, threads, cap, region, listed, smem)


def _staging(face_table):
    """Whether the rows of `face_table` [R, chunk, D] take 16-byte copies
    (the table 16-byte aligned, rows of a multiple of 4 floats), as an
    int; raises where its rows overflow the kernels' int32 numbering."""
    if face_table.shape[0] * face_table.shape[1] >= 2 ** 31:
        raise ValueError("the sweep numbers face-table rows in int32")
    return int(face_table.data_ptr() % 16 == 0
               and face_table.shape[2] % 4 == 0)


def _sweep_args(face_table, pix):
    """sweep_shape's arguments of the run walk's C entry points (K1, K5b,
    K8) for `face_table` [R, chunk, D]: groups, cap, region, list,
    _staging, and the shared memory's bytes."""
    s = sweep_shape(pix, face_table.shape[1],
                    _cuda.shared_memory_optin(face_table.device))
    return [s.groups, s.cap, s.region, s.list, _staging(face_table), s.smem]


def raster_sweep_plain(face_table, starts, counts, block_ids, channels,
                       height, width, tiles_x, num_tiles, tile_h, tile_w):
    """Per-pixel state [B*T, C+9, PIX] of the CSR sweep: tile bt sweeps
    the face blocks block_ids[starts[bt] : starts[bt] + counts[bt]] in
    order through forward_dense._chunk_candidates / merge_state."""
    last = block_ids.shape[0] - 1

    def visit_rows(r0, r1, m):
        bid = block_ids[(starts[r0:r1].long() + m).clamp(max=last)]
        return face_table[bid.long()]
    return forward_dense.sweep_plain(visit_rows, counts, channels, height,
                                     width, tiles_x, num_tiles, tile_h,
                                     tile_w, face_table.shape[1])


def split_slots(slots, piece=SWEEP_PIECE):
    """The extra pieces an image of `slots` CSR slots can give K1 at most:
    its runs' visits sum to at most `slots`, and a run of n visits gives
    ceil(n / piece) - 1 <= (n - 1) // piece."""
    return max(0, slots - 1) // piece


def sweep_plan(counts, num_tiles, slots, piece=SWEEP_PIECE):
    """raster_sweep.cu's plan, the plain version: for counts [B*T] of
    images of `slots` CSR slots, (first [B*T], map [B*E]) with E =
    split_slots(slots, piece): run bt's pieces 1 .. ceil(n / piece) - 1
    take the consecutive slots from first[bt] in run order from its
    image's first slot b * E, and map[slot] = bt, -1 where unused."""
    extra_slots = split_slots(slots, piece)
    extra = torch.where(counts > piece, (counts - 1) // piece, 0).long()
    per_image = extra.reshape(-1, num_tiles)
    excl = per_image.cumsum(-1) - per_image
    base = torch.arange(per_image.shape[0], device=counts.device)[:, None]
    first = (excl + base * extra_slots).reshape(-1)
    slot = (torch.repeat_interleave(first, extra)
            + torch.arange(int(extra.sum()), device=counts.device)
            - torch.repeat_interleave(extra.cumsum(0) - extra, extra))
    plan = torch.full((per_image.shape[0] * extra_slots,), -1,
                      dtype=torch.int32, device=counts.device)
    plan[slot] = torch.repeat_interleave(
        torch.arange(counts.shape[0], dtype=torch.int32,
                     device=counts.device), extra)
    return first.int(), plan


def sweep_chain(counts, piece=SWEEP_PIECE):
    """The most visits one block of K1 sweeps (counter forward.chain):
    min(n, piece) over the runs' counts."""
    return counts.clamp(max=piece).amax()


def raster_sweep(face_table, starts, counts, block_ids, channels,
                 height, width, tiles_x, num_tiles, tile_h, tile_w,
                 piece=SWEEP_PIECE):
    """K1 wrapper: raster_sweep_plain's state, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.  The kernel's blocks
    sweep at most `piece` visits each (SWEEP_PIECE; the tests cut runs
    finer); counter forward.chain (sweep_chain).

    face_table [B*NB, chunk, D] f32; starts, counts [B*T] and block_ids
    [B*S] int32, batch-folded (ids index the flat table)."""
    profiling.count("forward.chain", lambda: sweep_chain(counts, piece))
    if not _cuda.on_cuda(face_table, starts, counts, block_ids):
        return raster_sweep_plain(face_table, starts, counts, block_ids,
                                  channels, height, width, tiles_x,
                                  num_tiles, tile_h, tile_w)
    if piece < 1:
        raise ValueError(f"a K1 block sweeps at least one visit, not {piece}")
    runs = starts.shape[0]
    chunk, width_d = face_table.shape[1], face_table.shape[2]
    pix = tile_h * tile_w
    images = runs // num_tiles
    slots = images * split_slots(block_ids.shape[0] // max(images, 1), piece)
    shape = _sweep_args(face_table, pix)
    device = face_table.device
    state = torch.empty(runs, channels + 9, pix, device=device)
    # The plan's first slots and tickets a run, then its slot map; the
    # extra pieces' partial winners (depth, index, row) a pixel.
    plan = torch.empty(2 * runs + slots, dtype=torch.int32, device=device)
    partials = torch.empty(slots, 3, pix, device=device)
    RASTER_SWEEP(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("starts", starts, torch.int32, (runs,)),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("block_ids", block_ids, torch.int32),
        _cuda.check("state", state, torch.float32),
        plan[:runs].data_ptr(), plan[2 * runs:].data_ptr(),
        plan[runs:2 * runs].data_ptr(), partials.data_ptr(),
        runs, slots, piece, num_tiles, tiles_x, tile_h, tile_w, chunk,
        width_d, channels, 2.0 / width, 2.0 / height, height, width, *shape,
        _cuda.stream())
    return state


# --------------------------------------------------------------------------
# K5: the resident-table sweep
# --------------------------------------------------------------------------

RESIDENT_SWEEP = _cuda.Kernel(
    "resident_sweep", "dirt_resident_sweep",
    [_cuda.ptr] * 5 + [_cuda.i32] * 9 + [_cuda.f32] * 2 + [_cuda.i32] * 8
    + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:529",
    source="resident_sweep.cu")

# Tiles a K5 block takes (the last group of an image may hold fewer),
# chosen by trials (PERF.md); mirrors resident_sweep.cu's kResidentTiles.
RESIDENT_TILES = 1

ResidentShape = collections.namedtuple(
    "ResidentShape", "groups threads region list table_at smem")


@functools.lru_cache(maxsize=None)
def resident_shape(pix, faces, optin):
    """The ResidentShape of a K5 launch on tiles of `pix` pixels and an
    image's table of `faces` rows, under `optin` bytes of shared memory a
    block: sweep_shape's groups, threads and visit list; region, the
    floats of the group combine's (S - 1) * pix winners of 7 words;
    table_at, the float where the resident table starts (after the
    region and the list, 16-byte aligned); smem, the bytes of the whole,
    whose table holds FACE_FLOATS floats a face.  Raises where that
    exceeds `optin`."""
    s = sweep_shape(pix, 1, optin)   # groups, threads, list: any chunk
    region = _cdiv((s.groups - 1) * pix * 7, 4) * 4
    table_at = _cdiv(region + s.list, 4) * 4
    smem = 4 * (table_at + faces * FACE_FLOATS)
    if smem > optin:
        raise ValueError(f"an image's table of {faces} faces takes {smem} "
                         f"bytes of shared memory, over the block's {optin}")
    return ResidentShape(s.groups, s.threads, region, s.list, table_at, smem)


def resident_sweep_plain(face_table, starts, counts, block_ids, channels,
                         height, width, tiles_x, num_tiles, tile_h, tile_w):
    """raster_sweep_plain's state, each visit reading its rows from the
    image's own table [NB, chunk, D] by per-image block index."""
    batch = starts.shape[0] // num_tiles
    num_blocks = face_table.shape[0] // batch
    tables = face_table.reshape(batch, num_blocks, *face_table.shape[1:])
    last = block_ids.shape[0] - 1

    def visit_rows(r0, r1, m):
        image = torch.arange(r0, r1, device=starts.device) // num_tiles
        bid = block_ids[(starts[r0:r1].long() + m).clamp(max=last)]
        return tables[image, bid.long() % num_blocks]
    return forward_dense.sweep_plain(visit_rows, counts, channels, height,
                                     width, tiles_x, num_tiles, tile_h,
                                     tile_w, face_table.shape[1])


def resident_sweep(face_table, starts, counts, block_ids, channels,
                   height, width, tiles_x, num_tiles, tile_h, tile_w):
    """K5 wrapper: resident_sweep_plain's state (equal to raster_sweep's
    bit for bit), by the CUDA kernel for CUDA tensors and by the plain
    version for CPU tensors.  The arguments are raster_sweep's; the
    kernel holds the FACE_FLOATS leading columns of each image's table
    (NB * chunk faces) in shared memory, and raises where they exceed
    the device's opt-in shared memory per block (resident_shape)."""
    if not _cuda.on_cuda(face_table, starts, counts, block_ids):
        return resident_sweep_plain(face_table, starts, counts, block_ids,
                                    channels, height, width, tiles_x,
                                    num_tiles, tile_h, tile_w)
    runs = starts.shape[0]
    chunk, width_d = face_table.shape[1], face_table.shape[2]
    pix = tile_h * tile_w
    num_blocks = face_table.shape[0] // (runs // num_tiles)
    vec16 = _staging(face_table)
    shape = resident_shape(pix, num_blocks * chunk,
                           _cuda.shared_memory_optin(face_table.device))
    state = torch.empty(runs, channels + 9, pix, device=face_table.device)
    RESIDENT_SWEEP(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("starts", starts, torch.int32, (runs,)),
        _cuda.check("counts", counts, torch.int32, (runs,)),
        _cuda.check("block_ids", block_ids, torch.int32),
        _cuda.check("state", state, torch.float32),
        runs, num_blocks, num_tiles, tiles_x, tile_h, tile_w, chunk,
        width_d, channels, 2.0 / width, 2.0 / height, height, width,
        shape.groups, shape.region, shape.list, vec16, shape.table_at,
        shape.smem, _cuda.stream())
    return state


# --------------------------------------------------------------------------
# K5b: the sweep over slot lists
# --------------------------------------------------------------------------

SLOT_SWEEP = _cuda.Kernel(
    "slot_sweep", "dirt_slot_sweep",
    [_cuda.ptr] * 5 + [_cuda.i32] * 9 + [_cuda.f32] * 2 + [_cuda.i32] * 8
    + [_cuda.ptr],
    replaces="dirt_tpu/ops/forward_blocks.py:445", source="slot_sweep.cu")


def slot_sweep_plain(face_table, slot_tile, slot_block, slot_dma, batch,
                     channels, height, width, tiles_x, num_tiles, tile_h,
                     tile_w):
    """Per-pixel state [B*T, C+9, PIX] of the slot schedule: tile bt
    sweeps the face blocks of its live slots (slot_tile == bt, slot_block
    >= 0) in slot order; a tile without one keeps the background."""
    starts, counts, block_ids = slot_runs(slot_tile, slot_block, slot_dma,
                                          batch * num_tiles)
    return raster_sweep_plain(face_table, starts, counts, block_ids,
                              channels, height, width, tiles_x, num_tiles,
                              tile_h, tile_w)


def slot_sweep(face_table, slot_tile, slot_block, slot_dma, batch, channels,
               height, width, tiles_x, num_tiles, tile_h, tile_w):
    """K5b wrapper: slot_sweep_plain's state, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    face_table [B*NB, chunk, D] f32; slot_tile [B*S] (batch-folded tile,
    non-decreasing), slot_block [B*S] (per-image block, -1 for no-op
    slots) and slot_dma [B*S] (batch-folded block) int32."""
    if not _cuda.on_cuda(face_table, slot_tile, slot_block, slot_dma):
        return slot_sweep_plain(face_table, slot_tile, slot_block, slot_dma,
                                batch, channels, height, width, tiles_x,
                                num_tiles, tile_h, tile_w)
    runs = batch * num_tiles
    slots = slot_tile.shape[0]
    chunk, width_d = face_table.shape[1], face_table.shape[2]
    pix = tile_h * tile_w
    shape = _sweep_args(face_table, pix)
    state = torch.empty(runs, channels + 9, pix, device=face_table.device)
    SLOT_SWEEP(
        _cuda.check("face_table", face_table, torch.float32),
        _cuda.check("slot_tile", slot_tile, torch.int32, (slots,)),
        _cuda.check("slot_block", slot_block, torch.int32, (slots,)),
        _cuda.check("slot_dma", slot_dma, torch.int32, (slots,)),
        _cuda.check("state", state, torch.float32),
        runs, slots, num_tiles, tiles_x, tile_h, tile_w, chunk, width_d,
        channels, 2.0 / width, 2.0 / height, height, width, *shape,
        _cuda.stream())
    return state


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

# A pass's schedule as data: its spans' and counters' prefix; the face
# table's bbox columns and first edge column; K4's dilation; whether the
# runs are the face blocks (the gradient: the transposed hits, items are
# tiles) or the tiles; the counter of the CSR runs' visits, if any.
Pass = collections.namedtuple("Pass", "name bbox edge dilate by_block visits")
FORWARD = Pass("forward", _BBOX, 0, 0, False, "forward.visits")


def schedule(pass_, vertices, faces, attrs, height, width, tile_h, tile_w,
             chunk, slots):
    """A pass's schedule for a batch, in spans dirt.<name>.table (the face
    table of vertex attributes `attrs`, or the gradient's for None, padded
    to [B, NB*chunk, D] and Morton-sorted when SPATIAL: face_table; the
    forward's counters forward.clipped and forward.culled), dirt.<name>.hits (K4;
    counter <name>.hit_window) and dirt.<name>.runs (counters
    <name>.dropped, <name>.budget on the CSR runs, and pass_.visits):
    returns (face_table [B*NB,
    chunk, D], the runs folded over the batch, dropped [B], order [B,
    NB*chunk] the table row each sorted row came from).

    The [B, R, I] hits are [B, T, NB], or their transpose where
    pass_.by_block.  The runs are CSR (starts + S*b, counts, ids + I*b),
    or with `slots` the slot schedule (slot_run + R*b, slot_item per
    image, slot_dma + I*b, dirt_tpu's layout)."""
    batch, num_faces = faces.shape[:2]
    num_blocks = _cdiv(num_faces, chunk)
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    with profiling.span(f"dirt.{pass_.name}.table", vertices):
        face_data, order = face_table(
            vertices, faces, attrs, height, width, num_blocks * chunk,
            (tile_h, tile_w) if SPATIAL else None)
        if pass_ is FORWARD and profiling.recording():
            # Both passes' tables clip the same faces: counted once.
            clip = functools.cache(
                lambda: clip_counts(vertices, faces, height, width))
            profiling.count("forward.clipped", lambda: clip()[:, 0])
            profiling.count("forward.culled", lambda: clip()[:, 1])
    with profiling.span(f"dirt.{pass_.name}.hits", face_data):
        hit = hit_matrix(face_data, pass_.bbox, num_blocks, chunk, tiles_y,
                         tiles_x, tile_h, tile_w, edge_cols=pass_.edge,
                         height=height, width=width, dilate=pass_.dilate,
                         counter=f"{pass_.name}.hit_window")
    view = hit.transpose(1, 2) if pass_.by_block else hit
    _, num_runs, num_items = view.shape
    num_slots = slots_per_image(num_runs, num_items)
    with profiling.span(f"dirt.{pass_.name}.runs", hit):
        if slots:
            *runs, dropped = build_slots(view, num_slots)
            offsets = (num_runs, 0, num_items)    # slot_run, _item, _dma
        else:
            *runs, dropped = build_runs(view, num_slots)
            if pass_.visits:
                profiling.count(pass_.visits, runs[1])
            counts = runs[1]
            profiling.count(f"{pass_.name}.budget", lambda: (
                (counts.sum(-1) + dropped).amax() * BUDGET_UNIT) // num_slots)
            offsets = (num_slots, 0, num_items)   # starts, counts, ids
        profiling.count(f"{pass_.name}.dropped", dropped)
        boff = torch.arange(batch, dtype=torch.int32,
                            device=vertices.device)[:, None]
        runs = tuple((t + n * boff if n else t).reshape(-1)
                     for t, n in zip(runs, offsets))
        return (face_data.reshape(batch * num_blocks, chunk, -1), runs,
                dropped, order)


def pack(vertices, vertex_colors, faces, height, width, tile_h, tile_w,
         chunk, slots=False):
    """The forward schedule for a batch (schedule): (face_table [B*NB,
    chunk, D], starts [B*T], counts [B*T], block_ids [B*S], dropped [B]),
    or with `slots` (face_table, slot_tile [B*S], slot_block [B*S],
    slot_dma [B*S], dropped [B])."""
    face_table, runs, dropped, _ = schedule(
        FORWARD, vertices, faces, vertex_colors, height, width, tile_h,
        tile_w, chunk, slots)
    return (face_table, *runs, dropped)


def rasterise_batch(background, vertices, vertex_colors, faces,
                    tile_h=TILE_H, tile_w=TILE_W, chunk=CHUNK):
    """Batched forward rasterisation through the block-binned schedule:
    the CSR runs swept by K1, or by K5 when RESIDENT_MB admits the
    image's table; the slot schedule (K5b) when FUSED is off.

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
    face_table, *runs, dropped = pack(vertices, vertex_colors, faces, height,
                                      width, tile_h, tile_w, chunk,
                                      slots=not FUSED)
    grid = (tiles_x, num_tiles, tile_h, tile_w)
    if FUSED:
        sweep = (resident_sweep if takes_resident(face_table, batch)
                 else raster_sweep)
        args = (channels, height, width, *grid)
    else:
        sweep, args = slot_sweep, (batch, channels, height, width, *grid)
    with profiling.span("dirt.forward.sweep", face_table):
        state = sweep(face_table, *runs, *args)
    with profiling.span("dirt.forward.finalize", state):
        state = state.reshape(batch, num_tiles, channels + 9,
                              tile_h * tile_w)
        pixels, aux = forward_dense.finalize(state, background, height,
                                             width, tiles_y, tiles_x,
                                             tile_h=tile_h, tile_w=tile_w)
    return pixels, aux._replace(dropped=dropped)
