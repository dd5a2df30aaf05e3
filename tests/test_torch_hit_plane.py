"""K4 hit_plane's block hits, on the CPU.

The kernel (dirt_tpu_torch/csrc/hit_plane.cu) decides the [B, T, NB]
block hits itself: each lane takes one face, bounds the tiles its bbox
compares can pass (forward_blocks.tile_range), a min / max over the
block's lanes gives the block's tile window, every member face is tested
on the window's tiles and a warp vote ORs the tests; one lane stores the
byte where the vote is non-zero, into an output the wrapper zero-filled.
A chunk below 32 splits a warp into lane segments, a chunk above 32 ORs
its warps' votes through shared memory.  Here, on the plain side:

  * the decomposition: the launcher's grid and the kernel's index
    arithmetic, mirrored, lead each (image, block) from exactly one lane,
    at ragged sizes and past 65,535 images too, and the window loops
    write each (image, tile, block) byte at most once, every byte left
    unwritten a zero of the plain block hits;
  * the vote: a model of the window and the warp vote, the kernel's
    expression tree on the window's tiles only, is bitwise
    hit_blocks_plain, on the forward and the gradient face tables, at
    dilate 0 and 1, with and without the edge cull, at chunks 8, 32, 64
    and 128, and on rows with empty, reversed and non-finite bboxes;
  * the window counter: hit_windows (the counts the kernel writes while a
    profiler session records) sums to the model's, its windows hold
    every tile a member's bbox compares pass, and hit_matrix hands it to
    the counter of the span that is open; the benchmark's reader turns
    it into a share.

The kernel itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.check_hit_plane), where its hits are held to
hit_blocks_plain's bit for bit.
"""

import functools
import math
import pathlib
import sys
from types import SimpleNamespace

import pytest
import torch

from dirt_tpu_torch.ops import (forward_blocks, forward_pallas, grad_blocks,
                                grad_tables)
from dirt_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

WARP = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores (torch's small CPU ops then slow down many
    times over)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cdiv(a, b):
    return -(-a // b)


def hit_grid(batch, num_blocks, chunk):
    """dirt_hit_blocks' grid: (thread blocks, threads a thread block,
    thread blocks an image), in one dimension, an image's fastest."""
    threads = chunk if chunk > WARP else forward_blocks.HIT_THREADS
    parts = _cdiv(num_blocks * chunk, threads)
    return parts * batch, threads, parts


def leads(batch, num_blocks, chunk):
    """[B, NB] int: how many lanes of the grid lead each (image, block),
    the lane that stores its votes and its window count: thread t of
    thread block x takes face (x % parts) * threads + t of image x //
    parts; a warp whose first face is past the table returns; a live lane
    whose face is the first of its block (f % chunk == 0) leads block f //
    chunk."""
    blocks, threads, parts = hit_grid(batch, num_blocks, chunk)
    num_faces = num_blocks * chunk
    x = torch.arange(blocks, dtype=torch.int64)[:, None]
    t = torch.arange(threads)[None, :]
    first = (x % parts) * threads
    f = first + t
    runs = first + (t // WARP) * WARP < num_faces
    lead = runs & (f < num_faces) & (f % chunk == 0)
    index = ((x // parts) * num_blocks + f // chunk)[lead]
    count = torch.zeros(batch * num_blocks, dtype=torch.int64)
    count.index_add_(0, index, torch.ones_like(index))
    return count.reshape(batch, num_blocks)


@pytest.mark.parametrize("batch,num_blocks,chunk", [
    (32, 2048, 32),      # the 32-view cell: 65,536 faces
    (4, 2048, 32),       # the 4-view cell
    (16, 16, 32),        # the bench
    (3, 10, 32),         # 300 faces padded to blocks, past a thread block
    (2, 5, 8),           # segments of 8 lanes, a warp partly past the end
    (1, 3, 16),          # two segments a warp, one block past them
    (2, 7, 1),           # one-face blocks
    (2, 3, 64),          # two warps a block
    (2, 2, 128),         # four warps a block
    (1, 1, 1024),        # the largest chunk
    (70000, 1, 32),      # more images than a grid's y or z may hold
    (66000, 3, 8),       # and past 65,535 thread blocks a row
])
def test_hit_grid_leads_every_block_once(batch, num_blocks, chunk):
    blocks = hit_grid(batch, num_blocks, chunk)[0]
    assert blocks < 2 ** 31
    assert torch.equal(leads(batch, num_blocks, chunk),
                       torch.ones(batch, num_blocks, dtype=torch.int64))


def test_hit_grid_fills_the_card_at_the_cells():
    # 16,384 thread blocks of 128 threads at 32 views of 65,536 faces,
    # 2,048 at 4 views: past the card's 132 SMs many times over.
    assert hit_grid(32, 2048, 32) == (16384, 128, 512)
    assert hit_grid(4, 2048, 32) == (2048, 128, 512)
    assert hit_grid(16, 16, 32) == (64, 128, 4)
    assert hit_grid(2, 3, 64)[1:] == (64, 3)
    assert forward_blocks.HIT_THREADS % WARP == 0
    assert forward_blocks.HIT_MAX_CHUNK == 1024


# --------------------------------------------------------------------------
# A model of the window and the vote
# --------------------------------------------------------------------------

def face_keeps(rows, bbox_cols, edge_col, ty, tx, tile_h, tile_w, height,
               width, dilate):
    """[n, chunk] bool: hit_plane.cu's `keeps` for the faces `rows`
    ([chunk, D]) on the tiles (ty[i], tx[i]): the tile constants from the
    tile, the face's columns and margins once, the four bbox compares,
    then the edge test where they pass."""
    tile_r0 = (ty * tile_h).float()[:, None]
    tile_c0 = (tx * tile_w).float()[:, None]
    r0, r1, c0, c1 = (rows[None, :, c] for c in bbox_cols)
    k = ((r0 <= tile_r0 + (tile_h - 1)) & (r1 >= tile_r0)
         & (c0 <= tile_c0 + (tile_w - 1)) & (c1 >= tile_c0))
    if edge_col is None:
        return k
    c_lo = tile_c0 - dilate
    c_hi = (c_lo + (tile_w - 1)) + 2 * dilate
    r_lo = tile_r0 - dilate
    r_hi = (r_lo + (tile_h - 1)) + 2 * dilate
    x_lo = (c_lo + 0.5) * (2.0 / width) - 1.0
    x_hi = (c_hi + 0.5) * (2.0 / width) - 1.0
    y_hi = 1.0 - (r_lo + 0.5) * (2.0 / height)
    y_lo = 1.0 - (r_hi + 0.5) * (2.0 / height)
    any_max_neg = torch.zeros_like(k)
    any_min_pos = torch.zeros_like(k)
    for e in range(3):
        a, b, c = (rows[None, :, edge_col + 3 * e + i] for i in range(3))
        margin = ((a.abs() + b.abs()) + c.abs()) * (2.0 ** -20)
        a_pos, b_pos = a > 0, b > 0
        ax_max = a * torch.where(a_pos, x_hi, x_lo)
        ax_min = a * torch.where(a_pos, x_lo, x_hi)
        by_max = b * torch.where(b_pos, y_hi, y_lo)
        by_min = b * torch.where(b_pos, y_lo, y_hi)
        any_max_neg = any_max_neg | ((by_max + (ax_max + c)) < -margin)
        any_min_pos = any_min_pos | ((by_min + (ax_min + c)) > margin)
    return torch.where(k, ~(any_max_neg & any_min_pos), k)


def lane_range(lo, hi, tile, tiles):
    """tile_range of one lane, on Python floats rounded to float32 at each
    operation as the kernel's: (lo, hi) ints, or None where no tile."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    lo, hi = f32(lo), f32(hi)
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return 0, tiles - 1
    a = max(float(torch.ceil((lo - f32(tile - 1)) / f32(tile))) - 1.0, 0.0)
    b = min(float(torch.floor(hi / f32(tile))) + 1.0, float(tiles - 1))
    return None if a > b else (int(a), int(b))


def block_window(rows, bbox_cols, tiles_y, tiles_x, tile_h, tile_w):
    """One block's window, lane by lane: (ry0, ry1, cx0, cx1), or None."""
    r0c, r1c, c0c, c1c = bbox_cols
    bounds = []
    for row in rows.tolist():
        r = lane_range(row[r0c], row[r1c], tile_h, tiles_y)
        c = lane_range(row[c0c], row[c1c], tile_w, tiles_x)
        if r is not None and c is not None:
            bounds.append(r + c)
    if not bounds:
        return None
    return (min(b[0] for b in bounds), max(b[1] for b in bounds),
            min(b[2] for b in bounds), max(b[3] for b in bounds))


def vote_model(face_data, bbox_cols, num_blocks, chunk, tiles_y, tiles_x,
               tile_h, tile_w, edge_col, height, width, dilate):
    """The kernel's block hits, its stores counted and its windows' tile
    counts: ([B, T, NB] bool, [B, T, NB] int stores, [B, NB] int window).
    Each block's window is walked in the kernel's order (rows, then
    columns; a chunk above 32 in rounds of 32 tiles), its faces voting on
    each tile; a tile the vote keeps is stored, into zeros."""
    batch = face_data.shape[0]
    num_tiles = tiles_y * tiles_x
    hit = torch.zeros(batch, num_tiles, num_blocks, dtype=torch.bool)
    stores = torch.zeros(batch, num_tiles, num_blocks, dtype=torch.int64)
    window = torch.zeros(batch, num_blocks, dtype=torch.int64)
    for b in range(batch):
        for nb in range(num_blocks):
            rows = face_data[b, nb * chunk:(nb + 1) * chunk]
            box = block_window(rows, bbox_cols, tiles_y, tiles_x, tile_h,
                               tile_w)
            if box is None:
                continue
            ry0, ry1, cx0, cx1 = box
            cols = cx1 - cx0 + 1
            n = (ry1 - ry0 + 1) * cols
            window[b, nb] = n
            i = torch.arange(n)
            if chunk > WARP:
                # Round base, lane j: tile base + j, each once.
                i = torch.cat([torch.arange(base, min(base + WARP, n))
                               for base in range(0, n, WARP)])
            ty, tx = ry0 + i // cols, cx0 + i % cols
            vote = face_keeps(rows, bbox_cols, edge_col, ty, tx, tile_h,
                              tile_w, height, width, dilate).any(dim=-1)
            t = (ty * tiles_x + tx)[vote]
            hit[b, t, nb] = True
            stores[b, t, nb] += 1
    return hit, stores, window


SCENES = {
    "bench 2x64^2": lambda: chip_smoke.bench_scene(2, 64, 16, "cpu")[:4],
    "crossing 2x100^2": lambda: chip_smoke.crossing_scene("cpu",
                                                          size=100)[:4],
    "close-up 1x96^2": lambda: chip_smoke.bench_scene(
        1, 96, 8, "cpu", right=chip_smoke.ZOOM_RIGHT)[:4],
}
CHUNKS = (8, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _tables(name):
    """The forward face table (bbox columns 20-23, edge coefficients from
    column 0) and the gradient one (bbox 0-3, edges from 12) of scene
    `name`, [B, F', D] each, padded past the faces to a multiple of 128
    rows and by 40 rows more than that where it is one already."""
    background, clip, colors, faces = SCENES[name]()
    height, width = background.shape[1:3]
    pad = _cdiv(faces.shape[1] + 1, 128) * 128 - faces.shape[1]
    forward = forward_pallas._face_table(clip, colors, faces, height, width,
                                         pad)
    grad = grad_tables._grad_face_table(clip, faces, height, width, pad)
    return height, width, {"forward": (forward, forward_blocks._BBOX, 0),
                           "grad": (grad, grad_blocks._BBOX, 12)}


def _args(face_data, bbox_cols, chunk, height, width, edge_col, dilate):
    return (face_data, bbox_cols, face_data.shape[1] // chunk, chunk,
            _cdiv(height, 16), _cdiv(width, 16), 16, 16, edge_col, height,
            width, dilate)


def _check_model(args):
    want = forward_blocks.hit_blocks_plain(*args)
    hit, stores, window = vote_model(*args)
    assert torch.equal(hit, want)
    # Each byte stored at most once, and only where the plain hits say
    # so: every byte left at zero is a zero of the plain block hits.
    assert int(stores.max()) <= 1
    assert not bool(want[stores == 0].any())
    counts = torch.empty(args[0].shape[0], args[2], dtype=torch.int32)
    forward_blocks.hit_blocks(*args, window=counts)
    assert torch.equal(counts.long(), window)
    return want, window


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("table", ["forward", "grad"])
def test_vote_model_is_bitwise_the_plain_block_hits(name, table):
    height, width, tables = _tables(name)
    face_data, bbox_cols, edge_col = tables[table]
    for chunk in CHUNKS:
        for edges in (True, False):
            for dilate in (0, 1):
                args = _args(face_data, bbox_cols, chunk, height, width,
                             edge_col if edges else None, dilate)
                want, window = _check_model(args)
                assert int(want.sum()) > 0
                if chunk == CHUNKS[0]:
                    # Both outcomes occur, and the windows leave pairs
                    # out (at larger chunks the crossing scene's blocks
                    # reach every tile).
                    assert int(want.sum()) < want.numel()
                    assert int(window.sum()) < want.numel()
                if edges:
                    bbox_only = forward_blocks.hit_blocks_plain(
                        *args[:8], None, *args[9:])
                    assert int(bbox_only.sum()) >= int(want.sum())


@pytest.mark.parametrize("table", ["forward", "grad"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_vote_model_on_degenerate_bboxes(table, chunk):
    height, width, tables = _tables("crossing 2x100^2")
    face_data, bbox_cols, edge_col = tables[table]
    fd = chip_smoke.degenerate_rows(face_data, bbox_cols, edge_col)
    for edges in (edge_col, None):
        for dilate in (0, 1):
            _check_model(_args(fd, bbox_cols, chunk, height, width, edges,
                               dilate))
    # A non-finite bound opens its block's window to the whole image.
    window = forward_blocks.hit_windows(fd, bbox_cols, fd.shape[1] // chunk,
                                        chunk, 7, 7, 16, 16)
    assert int(window[0, (8 + 8 * 2) // chunk]) == 49
    assert int(window[0, (8 + 8 * 4) // chunk]) == 49


def test_lane_range_meets_every_compare_that_passes():
    # Every tile whose two compares pass lies in the lane's range, and the
    # range is empty only where none passes, on bounds around tile edges.
    tiles, tile = 7, 16
    starts = torch.arange(tiles) * tile
    values = [-40.0, -17.0, -16.0, -15.5, -1.0, -0.5, 0.0, 0.5, 14.999,
              15.0, 15.5, 16.0, 31.0, 47.5, 95.0, 96.0, 111.0, 112.0,
              200.0]
    for lo in values:
        for hi in values:
            passes = (torch.tensor(lo) <= starts + (tile - 1)) & (
                torch.tensor(hi) >= starts)
            r = lane_range(lo, hi, tile, tiles)
            if r is None:
                assert not bool(passes.any()), (lo, hi)
                continue
            inside = (torch.arange(tiles) >= r[0]) & (
                torch.arange(tiles) <= r[1])
            assert not bool((passes & ~inside).any()), (lo, hi)
            assert r[1] - r[0] <= 2 + max(0, int(passes.sum()))


# --------------------------------------------------------------------------
# The window counter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_window_counter_sums_to_the_model(name):
    height, width, tables = _tables(name)
    for table in ("forward", "grad"):
        face_data, bbox_cols, _ = tables[table]
        for chunk in CHUNKS:
            num_blocks = face_data.shape[1] // chunk
            grid = (_cdiv(height, 16), _cdiv(width, 16), 16, 16)
            counts = forward_blocks.hit_windows(face_data, bbox_cols,
                                                num_blocks, chunk, *grid)
            model = sum(0 if box is None else
                        (box[1] - box[0] + 1) * (box[3] - box[2] + 1)
                        for b in range(face_data.shape[0])
                        for box in (block_window(
                            face_data[b, k * chunk:(k + 1) * chunk],
                            bbox_cols, *grid) for k in range(num_blocks)))
            assert int(counts.sum()) == model
            # Every tile a member's bbox compares pass is in the window.
            reach = forward_blocks.hit_blocks_plain(
                face_data, bbox_cols, num_blocks, chunk, *grid, None,
                height, width, 0)
            assert bool((reach.sum(dim=1) <= counts).all())


def test_hit_matrix_counts_windows_under_the_profiler():
    height, width, tables = _tables("bench 2x64^2")
    face_data, bbox_cols, edge_col = tables["forward"]
    num_blocks = face_data.shape[1] // 32
    grid = (_cdiv(height, 16), _cdiv(width, 16), 16, 16)
    kw = dict(edge_cols=edge_col, height=height, width=width,
              counter="forward.hit_window")
    assert not profiling.recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        with profiling.span("dirt.forward.hits", face_data):
            hit = forward_blocks.hit_matrix(face_data, bbox_cols, num_blocks,
                                            32, *grid, **kw)
    span = [r for r in profiling.records()
            if r.name == "dirt.forward.hits"][-1]
    want = forward_blocks.hit_windows(face_data, bbox_cols, num_blocks, 32,
                                      *grid)
    assert span.counters == {"forward.hit_window": int(want.sum())}
    assert torch.equal(hit, forward_blocks.hit_matrix(
        face_data, bbox_cols, num_blocks, 32, *grid, **kw))


def test_window_share_reader(monkeypatch):
    from bench_h100.harness import spec
    read = spec.metric_reader("ops.hits.window_share")
    trace = SimpleNamespace(steps=2)

    def records(counted):
        spans = []
        for step in range(4):         # two device-only, two host steps
            t = step * 100
            spans.append(SimpleNamespace(name="dirt.forward", start_ns=t,
                                         end_ns=t + 50, stream_ms=1.0,
                                         counters={}))
            spans += [SimpleNamespace(name=n, start_ns=t + 1, end_ns=t + 2,
                                      stream_ms=1.0, counters=dict(c))
                      for n, c in counted]
        return lambda: spans

    readings = SimpleNamespace(trace=trace, span_trace=trace, batch=4,
                               height=64, width=48, num_faces=100)
    # 4 x 3 tiles and 4 blocks of 32 in each pack: 48 pairs an image; the
    # device-only profile's two steps of four images are read.
    both = [("dirt.forward.hits", {"forward.hit_window": 96}),
            ("dirt.backward.hits", {"backward.hit_window": 192})]
    monkeypatch.setattr(profiling, "records", records(both))
    assert read(readings) == pytest.approx(
        100.0 * 2 * (96 + 192) / (2 * 48 * 2 * 4))
    monkeypatch.setattr(profiling, "records", records(both[:1]))
    assert read(readings) == pytest.approx(100.0 * 2 * 96 / (48 * 2 * 4))
    monkeypatch.setattr(profiling, "records", records([]))
    assert read(readings) is None
    monkeypatch.delattr(profiling, "records")
    assert read(readings) is None
