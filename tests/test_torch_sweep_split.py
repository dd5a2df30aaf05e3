"""The run walk of K1 raster_sweep and K5b slot_sweep, on the CPU.

sweep_math.cuh's sweep_run deals each visit's faces to S face groups
(face k of a visit to group k mod S), sweeps each group's share into its
own winners and combines the groups' winners in group order by the
lexicographic (depth, original index) test.  Because that order is total
among covered fragments of one image, the state must equal the plain
version's, which walks every face in order, bit for bit.  Here:

  * that argument on the plain side: each group's share swept by
    forward_dense.sweep_plain, the group states combined by
    forward_dense.merge_state in the kernel's order (and in every other
    order), against raster_sweep_plain, on a camera-crossing soup, the
    100x100 bench scene and a scene of duplicated faces (exact depth ties,
    where the lower index must win);
  * the bbox cull: each plain winner's pixel bbox holds its pixel, so
    testing a face only inside its bbox keeps the plain state;
  * K5b's fill: slots.cuh's find_slot_run, mirrored, against
    searchsorted (three rounds on a 36,864-slot list), and the compacted
    visit list against forward_blocks.slot_runs' CSR of the live slots;
  * forward_blocks.sweep_shape and its mirror of the kernels' constants.

The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import itertools
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from dirt_tpu_torch.ops import forward_blocks, forward_dense

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

H100_OPTIN = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on the H100
TILE, CHUNK = 16, 32


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


SCENES = {
    "crossing": lambda: chip_smoke.crossing_scene("cpu")[:4],
    "bench 4x100^2": lambda: chip_smoke.bench_scene(4, 100, 64, "cpu")[:4],
    "ties": lambda: chip_smoke.tie_scene("cpu"),
}


def _sweep_inputs(name):
    background, clip, colors, faces = SCENES[name]()
    batch, height, width, channels = background.shape
    tiles_x = -(-width // TILE)
    num_tiles = -(-height // TILE) * tiles_x
    table, starts, counts, block_ids, _ = forward_blocks.pack(
        clip, colors, faces, height, width, TILE, TILE, CHUNK)
    return (table, starts, counts, block_ids, channels, height, width,
            tiles_x, num_tiles, TILE, TILE)


def _group_states(args, groups):
    """Each face group's state: group g sweeps faces g, g + S, ... of every
    visit of its run, as sweep_run deals them."""
    table, starts, counts, block_ids, channels, height, width, tiles_x, \
        num_tiles, tile_h, tile_w = args
    last = block_ids.shape[0] - 1
    states = []
    for g in range(groups):
        def visit_rows(r0, r1, m, g=g):
            bid = block_ids[(starts[r0:r1].long() + m).clamp(max=last)]
            return table[bid.long()][:, g::groups]
        states.append(forward_dense.sweep_plain(
            visit_rows, counts, channels, height, width, tiles_x, num_tiles,
            tile_h, tile_w, table.shape[1]))
    return states


def _combine(states, order):
    ns = states[0].shape[1]
    out = states[order[0]]
    for g in order[1:]:
        s = states[g]
        out = forward_dense.merge_state(out, s, s[:, ns - 2:ns - 1],
                                        s[:, ns - 1:ns], ns)
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_face_groups_combine_to_the_plain_state(name):
    args = _sweep_inputs(name)
    want = forward_blocks.raster_sweep_plain(*args)
    groups = forward_blocks.sweep_shape(TILE * TILE, CHUNK, H100_OPTIN).groups
    assert groups == 2
    states = _group_states(args, groups)
    # The kernel's order: group 0 takes groups 1 .. S-1 in turn.
    assert torch.equal(_combine(states, range(groups)), want)
    # Any other order picks the same winners: (depth, index) is total.
    for order in itertools.permutations(range(groups)):
        assert torch.equal(_combine(states, order), want), order
    # Other partitions too: one group, four, and eight.
    for other in (1, 4, 8):
        assert torch.equal(_combine(_group_states(args, other),
                                    range(other)), want)
    if name == "ties":
        ns = want.shape[1]
        orig = want[:, ns - 1]
        covered = orig >= 0
        # Every covered fragment has a twin at the same depth; the lower
        # index, the first copy, wins.
        assert int(covered.sum()) > 500
        assert bool((orig[covered] < 60).all())


@pytest.mark.parametrize("name", list(SCENES))
def test_winners_lie_in_their_bbox(name):
    # sweep_run tests a face only at the pixels its pixel bbox holds (row
    # and column clamped to the image, as the bbox is).  That keeps the
    # plain state wherever each winner's bbox holds its pixel: the culled
    # faces are a subset that still holds the winner.
    args = _sweep_inputs(name)
    table, _, _, _, channels, height, width, tiles_x, num_tiles, th, tw = \
        args
    want = forward_blocks.raster_sweep_plain(*args)
    runs, ns, pix = want.shape
    batch = runs // num_tiles
    rows = table.reshape(batch, -1, table.shape[-1])
    live = rows[..., 18] != 0          # valid faces (padding rows are not)
    bbox = torch.full((batch, int(rows[..., 19].max()) + 1, 4), -1.0)
    for b in range(batch):
        bbox[b, rows[b, live[b], 19].long()] = rows[b, live[b]][
            :, list(forward_blocks._BBOX)]
    tile = torch.arange(runs) % num_tiles
    p = torch.arange(pix)
    row = ((tile // tiles_x) * th)[:, None] + p // tw
    col = ((tile % tiles_x) * tw)[:, None] + p % tw
    row, col = row.clamp(max=height - 1), col.clamp(max=width - 1)
    orig = want[:, ns - 1].long()
    covered = orig >= 0
    image = (torch.arange(runs) // num_tiles)[:, None].expand(-1, pix)
    box = bbox[image[covered], orig[covered]]
    r, c = row[covered].float(), col[covered].float()
    assert int(covered.sum()) > 100
    assert bool(((box[:, 0] <= r) & (r <= box[:, 1]) & (box[:, 2] <= c)
                 & (c <= box[:, 3])).all())


def warp_bracket(keys, lo, hi, key, bracket):
    """slots.cuh's warp_bracket: (lo, hi, rounds) with lower_bound in
    [lo, hi], hi - lo <= bracket, 32 probes a round."""
    rounds = 0
    while hi - lo > bracket:
        m = hi - lo
        at = [lo + (lane + 1) * m // 33 for lane in range(32)]
        assert all(lo < p < hi for p in at) and len(set(at)) == 32
        c = sum(1 for p in at if keys[p] < key)
        lo, hi = (lo if c == 0 else lo + c * m // 33 + 1,
                  hi if c == 32 else lo + (c + 1) * m // 33)
        rounds += 1
    return lo, hi, rounds


def find_slot_run(keys, item, dma, key):
    """slots.cuh's find_slot_run: (lo, hi, the compacted visits or None,
    rounds of dependent loads)."""
    n, window = len(keys), forward_blocks.SLOT_WINDOW
    base, _, rounds = warp_bracket(keys, 0, n, key, window - 32)
    idx = range(base, min(base + window, n))
    lo = base + sum(1 for i in idx if keys[i] < key)
    hi = lo + sum(1 for i in idx if keys[i] == key)
    if hi < base + window:
        return lo, hi, [dma[i] for i in idx
                        if keys[i] == key and item[i] >= 0], rounds + 1
    # warp_lower_bound(keys, base + window, n, key + 1)
    start, end, more = warp_bracket(keys, base + window, n, key + 1, 32)
    hi = start + sum(1 for i in range(start, end) if keys[i] < key + 1)
    return lo, hi, None, rounds + 1 + more + 1


def test_slot_search_against_searchsorted():
    # The bench's list length (16 images x 2,304 slots) in three rounds;
    # runs of up to 32 slots compacted by the search itself, longer ones
    # by a second search.
    rng = np.random.RandomState(0)
    fallbacks = 0
    for n, runs in ((36864, 4096), (36864, 300), (1000, 40), (96, 4),
                    (1, 1), (0, 1)):
        keys = np.sort(rng.randint(0, runs, size=n)).tolist()
        item = rng.randint(-1, 5, size=n).tolist()
        for key in range(-1, runs + 1, max(1, runs // 200)):
            lo, hi, visits, rounds = find_slot_run(keys, item, item, key)
            assert lo == int(np.searchsorted(keys, key, side="left"))
            assert hi == int(np.searchsorted(keys, key, side="right"))
            if visits is None:
                assert hi - lo >= 32
                fallbacks += 1
            else:
                assert visits == [v for v in item[lo:hi] if v >= 0]
                assert rounds <= (3 if n > 64 else 1)
    assert fallbacks > 0


@pytest.mark.parametrize("budget", [None, 40])
def test_compacted_slot_list_is_the_csr_of_live_slots(budget):
    background, clip, colors, faces = SCENES["crossing"]()
    batch, height, width, _ = background.shape
    num_tiles = -(-height // TILE) * -(-width // TILE)
    runs = batch * num_tiles
    if budget is None:
        packed = forward_blocks.pack(clip, colors, faces, height, width,
                                     TILE, TILE, CHUNK, slots=True)
    else:
        with chip_smoke.slot_budget(budget):
            packed = forward_blocks.pack(clip, colors, faces, height,
                                         width, TILE, TILE, CHUNK,
                                         slots=True)
    _, slot_tile, slot_block, slot_dma, dropped = packed
    assert (budget is None) == (int(dropped.sum()) == 0)
    threads = forward_blocks.sweep_shape(TILE * TILE, CHUNK,
                                         H100_OPTIN).threads
    starts, counts, ids = forward_blocks.slot_runs(slot_tile, slot_block,
                                                   slot_dma, runs)
    keys, item, dma = (t.tolist() for t in (slot_tile, slot_block, slot_dma))
    live_runs = 0
    for bt in range(runs):
        lo, hi, visits, _ = find_slot_run(keys, item, dma, bt)
        if visits is None:
            # SlotFill: windows of one slot a thread, live slots in order.
            visits = []
            for cursor in range(lo, hi, threads):
                visits += [dma[i] for i in range(cursor,
                                                 min(cursor + threads, hi))
                           if item[i] >= 0]
        s, n = int(starts[bt]), int(counts[bt])
        assert visits == ids[s:s + n].tolist()
        live_runs += n > 0
    assert live_runs > 0


def test_sweep_shape_at_the_bench_configuration():
    # 256-pixel tiles, 32-face blocks: two groups of 256 threads; 17 visits of 32 x 24 floats staged at once (the bench's
    # busiest run has 14); three blocks an SM fit its shared memory.
    s = forward_blocks.sweep_shape(256, 32, H100_OPTIN)
    assert s == forward_blocks.SweepShape(groups=2, threads=512, cap=17,
                                          region=13056, list=512, smem=54528)
    assert (forward_blocks.SWEEP_BLOCKS * (s.smem + 1024)
            <= forward_blocks.SM_SHARED_BYTES)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("pix", [35, 64, 100, 256, 512, 1024])
def test_sweep_shape_fits(pix, chunk):
    s = forward_blocks.sweep_shape(pix, chunk, H100_OPTIN)
    assert s.threads == s.groups * pix <= 1024
    assert s.groups == 1 or s.threads <= forward_blocks.SWEEP_THREADS
    assert s.threads >= 32
    assert s.list == max(s.threads, forward_blocks.SLOT_WINDOW)
    assert s.groups & (s.groups - 1) == 0
    assert s.groups == forward_blocks.SWEEP_GROUPS or (
        2 * s.groups * pix > forward_blocks.SWEEP_THREADS)
    assert s.cap >= 2
    visit = chunk * forward_blocks.FACE_FLOATS
    combine = (s.groups - 1) * pix * 7
    assert s.region % 4 == 0
    assert s.region >= max(s.cap * visit, combine)
    assert s.smem == 4 * (s.region + s.list + forward_blocks._SWEEP_SCRATCH)
    assert s.smem <= H100_OPTIN


def test_sweep_shape_limits():
    with pytest.raises(ValueError, match="exceeds a block's 1024"):
        forward_blocks.sweep_shape(2048, 32, H100_OPTIN)
    with pytest.raises(ValueError, match="under one warp"):
        forward_blocks.sweep_shape(8, 32, H100_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        forward_blocks.sweep_shape(256, 4096, H100_OPTIN)


def test_sweep_constants_mirror_the_kernels():
    text = (REPO / "dirt_tpu_torch" / "csrc" / "sweep_math.cuh").read_text()
    for name, value in (("kFaceFloats", forward_blocks.FACE_FLOATS),
                        ("kSweepGroups", forward_blocks.SWEEP_GROUPS),
                        ("kSweepThreads", forward_blocks.SWEEP_THREADS),
                        ("kSweepBlocks", forward_blocks.SWEEP_BLOCKS),
                        ("kSweepScratch", forward_blocks._SWEEP_SCRATCH)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    # test_face reads table columns 0-19, the bbox cull 20-23 (the
    # forward_blocks._BBOX columns): the staged face.
    body = text[text.index("void test_face("):
                text.index("// Writes the packed state")]
    cols = {int(c) for c in re.findall(r"\bf\[(\d+)\]", body)}
    assert max(cols) == 19
    # The bbox, the last float4 of the staged face.
    assert forward_blocks._BBOX == tuple(range(
        forward_blocks.FACE_FLOATS - 4, forward_blocks.FACE_FLOATS))
    assert "src[kFaceFloats / 4 - 1];   // r0, r1, c0, c1" in text
    for source in ("raster_sweep.cu", "slot_sweep.cu"):
        kernel = (REPO / "dirt_tpu_torch" / "csrc" / source).read_text()
        assert "__launch_bounds__(kMaxThreads, kMinBlocks)" in kernel
        assert "threads <= dirt::kSweepThreads" in kernel
        assert "dirt::kSweepBlocks>" in kernel and "<1024, 1>" in kernel
        assert "dirt::sweep_run(" in kernel
    assert forward_blocks.RASTER_SWEEP.argtypes.count(
        forward_blocks._cuda.i32) == 16
    assert forward_blocks.SLOT_SWEEP.argtypes.count(
        forward_blocks._cuda.i32) == 17
