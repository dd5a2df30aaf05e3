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

import functools
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


@functools.cache
def _reference(name):
    """The scene's sweep inputs and raster_sweep_plain's state of them."""
    args = _sweep_inputs(name)
    return args, forward_blocks.raster_sweep_plain(*args)


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
    args, want = _reference(name)
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
    args, want = _reference(name)
    table, _, _, _, channels, height, width, tiles_x, num_tiles, th, tw = \
        args
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


PIECES = (1, 2, forward_blocks.SWEEP_PIECE)


def _piece_states(args, piece, first, plan):
    """Each piece's state as raster_sweep.cu's blocks sweep it: piece k of
    run bt (k = 0, or slot first[bt] + k - 1 of the plan, which maps to bt)
    sweeps visits [k * piece, (k + 1) * piece) of the run through
    forward_dense.sweep_plain; runs without a piece k stay background."""
    table, starts, counts, block_ids, *geometry = args
    extra = torch.bincount(plan[plan >= 0].long(), minlength=counts.shape[0])
    pieces = torch.where(counts > 0, 1 + extra, 0)
    states = []
    for k in range(int(pieces.max())):
        if k:
            # The plan's slot of each run's piece k holds the run.
            has = pieces > k
            slot = first[has].long() + k - 1
            assert torch.equal(plan[slot], has.nonzero()[:, 0].int())
        n = torch.where(pieces > k, (counts - k * piece).clamp(max=piece), 0)
        states.append(forward_blocks.raster_sweep_plain(
            table, starts + k * piece, n.int(), block_ids, *geometry))
    return states


def _edge_args(args, piece):
    """Runs of piece, piece + 1 and 2 * piece + 1 visits of image 0's face
    blocks, ascending and repeating, on a one-image strip of three 16 x 16
    tiles (the same table rows, sampled at the strip's pixel centres)."""
    table, _, counts, _, channels, _, _, _, num_tiles, _, _ = args
    blocks = table.shape[0] // (counts.shape[0] // num_tiles)
    lengths = (piece, piece + 1, 2 * piece + 1)
    ids = torch.cat([torch.arange(n) % blocks for n in lengths]).int()
    n = torch.tensor(lengths, dtype=torch.int32)
    starts = (n.cumsum(0) - n).int()
    return (table[:blocks].contiguous(), starts, n, ids, channels, TILE,
            3 * TILE, 3, 3, TILE, TILE)


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("name", list(SCENES))
def test_pieces_merge_to_the_plain_state(name, piece):
    # raster_sweep.cu cuts a run of n > piece visits into pieces of at most
    # `piece` consecutive visits and merges their winners in piece order
    # by the (depth, original index) test.  That order is total among
    # covered fragments of one image, so the merged state equals the plain
    # state bit for bit in piece order and in any other: on runs of piece,
    # piece + 1 and 2 * piece + 1 visits, and on the scene's own runs
    # (shorter than SWEEP_PIECE: cut at 1 and 2).
    scene, scene_want = _reference(name)
    edge = _edge_args(scene, piece)
    cases = [(edge, forward_blocks.raster_sweep_plain(*edge))]
    if piece < int(scene[2].max()):
        cases.append((scene, scene_want))
    for args, want in cases:
        table, starts, counts, block_ids, *geometry = args
        runs, num_tiles = counts.shape[0], geometry[4]
        first, plan = forward_blocks.sweep_plan(
            counts, num_tiles, block_ids.shape[0] // (runs // num_tiles),
            piece)
        states = _piece_states(args, piece, first, plan)
        assert len(states) == -(-int(counts.max()) // piece)
        assert torch.equal(_combine(states, range(len(states))), want)
        orders = (itertools.permutations(range(len(states)))
                  if len(states) <= 3 else
                  [range(len(states))[::-1],
                   torch.randperm(len(states),
                                  generator=torch.Generator().manual_seed(
                                      piece)).tolist()])
        for order in orders:
            assert torch.equal(_combine(states, list(order)), want), order
        assert bool((want[:, -1] >= 0).any())
    if name == "ties":
        # The lower index, the first copy, wins every exact tie.
        assert bool((want[:, -1][want[:, -1] >= 0] < 60).all())


def _plan_loop(counts, num_tiles, slots, piece):
    """The plan and the longest chain, one run at a time."""
    extra_slots = max(0, slots - 1) // piece
    images = len(counts) // num_tiles
    first, plan, chain = [], [-1] * (images * extra_slots), 0
    for b in range(images):
        slot = b * extra_slots
        for bt in range(b * num_tiles, (b + 1) * num_tiles):
            n = counts[bt]
            first.append(slot)
            pieces = [min(piece, n - v) for v in range(0, n, piece)]
            chain = max([chain] + pieces)
            for _ in pieces[1:]:
                plan[slot] = bt
                slot += 1
        assert slot <= (b + 1) * extra_slots
    return first, plan, chain


@pytest.mark.parametrize("piece", (1, 2, 7, forward_blocks.SWEEP_PIECE))
def test_sweep_plan_against_a_loop(piece):
    # Images whose runs fill their slot budget exactly (the most extra
    # pieces the plan's slots must hold), partly, or not at all.
    gen = torch.Generator().manual_seed(piece)
    num_tiles, slots = 37, 700
    images = []
    for fill in (slots, slots // 3, 0):
        cuts = torch.sort(torch.randint(0, fill + 1, (num_tiles - 1,),
                                        generator=gen)).values
        edges = torch.cat([torch.tensor([0]), cuts, torch.tensor([fill])])
        images.append(edges[1:] - edges[:-1])
    # A run of all the slots, then nothing.
    images.append(torch.tensor([slots] + [0] * (num_tiles - 1)))
    counts = torch.cat(images).int()
    first, plan = forward_blocks.sweep_plan(counts, num_tiles, slots, piece)
    want_first, want_plan, chain = _plan_loop(counts.tolist(), num_tiles,
                                              slots, piece)
    assert first.tolist() == want_first
    assert plan.tolist() == want_plan
    assert len(plan) == len(images) * forward_blocks.split_slots(slots,
                                                                 piece)
    assert int(forward_blocks.sweep_chain(counts, piece)) == chain
    assert chain == min(piece, slots)


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
    split = (REPO / "dirt_tpu_torch" / "csrc" / "raster_sweep.cu"
             ).read_text()
    assert re.search(rf"constexpr int kSweepPiece = "
                     rf"{forward_blocks.SWEEP_PIECE};", split)
    assert forward_blocks.RASTER_SWEEP.argtypes.count(
        forward_blocks._cuda.i32) == 18
    assert forward_blocks.SLOT_SWEEP.argtypes.count(
        forward_blocks._cuda.i32) == 17
