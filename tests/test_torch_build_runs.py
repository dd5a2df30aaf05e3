"""K12 build_runs: the blocks schedules' CSR runs without a sort.

The kernel (dirt_tpu_torch/csrc/build_runs.cu) counts each run's live
items in one launch; the wrapper's cumsum of those counts gives the
starts and counts, clamped by the slot budget as build_runs_plain clamps
them; a second launch stores each run's live item ids, ascending, from
its start.  A warp walks a group of runs of one image along their items,
a step at a time; its lanes read V adjacent bytes (forward_blocks.
runs_layout: 4 where words line up, else 1) along the axis of the smaller
stride.  Along the items (the forward's rows) V ballots a load hand run k
its bits, which lane k interleaves into item order; along the runs (the
gradient's transposed view, read in place) each lane sets its own V
runs' bits.  Here, on the CPU:

  * the wrapper runs build_runs_plain for CPU tensors, launching
    nothing, and raises on hits that are not [B, R, I] bool, whatever
    their device; runs_layout picks the lanes' axis and width from the
    view's strides and address;
  * the kernel's grid leads each (image, run) from exactly one lane;
  * a model of the kernel, its loads, ballots and interleave in both
    orientations at both widths, its counts and its compact walk with the
    early stop, is build_runs_plain bit for bit at hit densities 0,
    0.001, 0.05 and 0.9, R and I that are not multiples of 32, on
    contiguous hits, on a transposed view and on a view one byte off its
    storage, under budgets of 1, one that cuts a run in the middle, and
    R x I + 4.

On the card (marked cuda; run as tests/test_torch_cuda.py says) the
kernel's four outputs are build_runs_plain's bit for bit over the same
cases and larger ones, two launches a call.
"""

import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from dirt_tpu_torch.ops import _cuda, forward_blocks

WARP = 32
THREADS = 128       # build_runs.cu's kThreads
DENSITIES = (0.0, 0.001, 0.05, 0.9)
# Widths (contiguous / transposed): 1 / 1, 1 / 1, 4 / 1, 1 / 4, 4 / 4.
SHAPES = ((3, 37, 45), (2, 70, 33), (1, 5, 100), (2, 132, 45), (1, 8, 260))
LAYOUTS = ("contiguous", "transposed", "offset")
SOURCE = (pathlib.Path(forward_blocks.__file__).resolve().parents[1]
          / "csrc" / "build_runs.cu").read_text()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def make_hits(shape, density, layout, seed=0):
    """[B, R, I] bool hits at `density`: contiguous; ("transposed") the
    transpose(1, 2) view of contiguous [B, I, R] hits, as the gradient
    pack hands them over; ("offset") the [..., 1:] view of contiguous
    [B, R, I + 1] hits, one byte past a word."""
    batch, runs, items = shape
    rng = np.random.RandomState(seed)
    if layout == "contiguous":
        return torch.as_tensor(rng.rand(batch, runs, items) < density)
    if layout == "offset":
        return torch.as_tensor(rng.rand(batch, runs, items + 1)
                               < density)[..., 1:]
    hits = torch.as_tensor(rng.rand(batch, items, runs) < density)
    return hits.transpose(1, 2)


def budgets(hit):
    """1; a budget that ends inside a run of image 0 with two or more
    live items (else one short of its live items); R x I + 4."""
    _, runs, items = hit.shape
    n = hit[0].sum(dim=-1)
    starts = n.cumsum(0) - n
    long_runs = torch.nonzero(n >= 2).flatten()
    if long_runs.numel():
        mid = int(starts[long_runs[long_runs.numel() // 2]]) + 1
    else:
        mid = max(1, int(n.sum()) - 1)
    return (1, mid, runs * items + 4)


def walk(hit):
    """(lanes on items, width V, runs a warp, items a step): Walk<V,
    kRow> of the layout the wrapper picks."""
    on_items, width = forward_blocks.runs_layout(hit)
    return (on_items, width, WARP if on_items else WARP * width,
            WARP * width if on_items else WARP)


def grid(batch, runs, group):
    """dirt_build_runs' grid: (groups of `group` runs an image, warps,
    thread blocks of THREADS threads)."""
    groups = -(-runs // group)
    warps = groups * batch
    return groups, warps, -(-warps // (THREADS // WARP))


def warp_of(block, thread, groups, group):
    """(warp, image, first run) of `thread` in thread block `block`, as
    build_runs_kernel derives them."""
    w = block * (THREADS // WARP) + thread // WARP
    return w, w // groups, (w % groups) * group


def spread4(x):
    """build_runs.cu's spread4: bits 0..7 of x to bits 0, 4, ..., 28."""
    x &= 0xFF
    x = (x | (x << 12)) & 0x000F000F
    x = (x | (x << 6)) & 0x03030303
    return (x | (x << 3)) & 0x11111111


def step_masks(array, layout, b, r0, i0):
    """step_masks of warp (image b, first run r0) at the step from item
    i0: {run: its masks of 32 items, in item order}, for every run of the
    warp's group.  The loads and their validity tests are the kernel's:
    a word a test, so a layout that let a word straddle the image's edge
    would index past the array here."""
    on_items, width, group, _ = layout
    _, runs, items = array.shape
    byte = lambda r, i: int(bool(array[b, r, i]))
    masks = {}
    if on_items:
        for k in range(WARP):
            # Load k: lane j reads the word of items i0 + V j .. of run
            # r0 + k; ballot t gathers byte t of every lane's word.
            ballots = [0] * width
            for j in range(WARP):
                if r0 + k < runs and i0 + width * j < items:
                    for t in range(width):
                        ballots[t] |= byte(r0 + k, i0 + width * j + t) << j
            if width == 1:
                masks[r0 + k] = ballots
            else:
                masks[r0 + k] = [
                    sum(spread4(ballots[t] >> (8 * q)) << t
                        for t in range(width)) for q in range(width)]
        return masks
    for lane in range(WARP):
        # Load k: lane j reads the word of runs r0 + V j .. at item i0 + k.
        r = r0 + width * lane
        words = [0] * width
        for k in range(WARP):
            if i0 + k < items and r < runs:
                for u in range(width):
                    words[u] |= byte(r + u, i0 + k) << k
        for u in range(width):
            masks[r + u] = [words[u]]
    return masks


def model(hit, num_slots):
    """The kernel's two launches and the wrapper's cumsum between them,
    on the CPU: (starts, counts, item_ids, dropped) and the steps the
    compact launch read."""
    batch, runs, items = hit.shape
    layout = walk(hit)
    _, _, group, step = layout
    array = hit.numpy()
    groups, warps, _ = grid(batch, runs, group)
    warp = lambda w: (w // groups, (w % groups) * group)
    n = torch.zeros(batch, runs, dtype=torch.int32)
    for w in range(warps):
        b, r0 = warp(w)
        count = dict.fromkeys(range(r0, r0 + group), 0)
        for i0 in range(0, items, step):
            for r, words in step_masks(array, layout, b, r0, i0).items():
                count[r] += sum(bin(m).count("1") for m in words)
        for r, c in count.items():
            if r < runs:
                n[b, r] = c
    starts, counts, dropped = forward_blocks._run_bounds(n, num_slots)
    ids = torch.zeros(batch, num_slots, dtype=torch.int32)
    steps = 0
    for w in range(warps):
        b, r0 = warp(w)
        left = {r: int(counts[b, r]) if r < runs else 0
                for r in range(r0, r0 + group)}
        slot = {r: int(starts[b, r]) if left[r] > 0 else 0 for r in left}
        i0 = 0
        while i0 < items and any(x > 0 for x in left.values()):
            steps += 1
            for r, words in step_masks(array, layout, b, r0, i0).items():
                for q, m in enumerate(words):
                    while m and left[r] > 0:
                        low = m & -m
                        ids[b, slot[r]] = i0 + WARP * q + low.bit_length() - 1
                        slot[r] += 1
                        left[r] -= 1
                        m ^= low
            i0 += step
    return (starts, counts, ids, dropped), steps


def assert_same(got, want):
    for what, g, w in zip(("starts", "counts", "item_ids", "dropped"), got,
                          want, strict=True):
        assert g.dtype == w.dtype == torch.int32, what
        assert g.shape == w.shape, what
        assert torch.equal(g.cpu(), w.cpu()), what


def test_source_mirrors():
    assert re.search(rf"constexpr int kWarp = {WARP};", SOURCE)
    assert re.search(rf"constexpr int kThreads = {THREADS};", SOURCE)
    assert forward_blocks.RUNS_WORD == 4
    assert "if constexpr (V == 4)" in SOURCE
    mine = inspect.getsource(spread4).lower()
    for step in ("(x | (x << 12)) & 0x000f000f",
                 "(x | (x << 6)) & 0x03030303",
                 "(x | (x << 3)) & 0x11111111"):
        assert step + "u" in SOURCE and step in mine


@pytest.mark.parametrize("byte", [0, 1, 0x80, 0xA5, 0xFF, 0x1FF])
def test_spread4_spaces_bits_by_four(byte):
    assert spread4(byte) == sum(((byte >> j) & 1) << (4 * j)
                                for j in range(8))


@pytest.mark.parametrize("layout,shape,want", [
    ("contiguous", (32, 1024, 2048), (True, 4)),
    ("transposed", (32, 2048, 1024), (False, 4)),
    ("contiguous", (2, 8, 45), (True, 1)),
    ("transposed", (2, 70, 8), (False, 1)),
    ("offset", (2, 8, 64), (True, 1)),
])
def test_runs_layout_follows_the_strides(layout, shape, want):
    batch, runs, items = shape
    hit = {"contiguous": lambda: torch.zeros(shape, dtype=torch.bool),
           "transposed": lambda: torch.zeros(
               batch, items, runs, dtype=torch.bool).transpose(1, 2),
           "offset": lambda: torch.zeros(
               batch, runs, items + 1, dtype=torch.bool)[..., 1:]}[layout]()
    assert forward_blocks.runs_layout(hit) == want


@pytest.mark.parametrize("batch,runs,group", [
    (1, 1, 32), (3, 37, 32), (2, 70, 128), (5, 64, 32), (70000, 5, 128)])
def test_grid_leads_each_run_once(batch, runs, group):
    groups, warps, blocks = grid(batch, runs, group)
    seen = np.zeros((batch, runs), np.int64)
    for block in range(blocks):
        for thread in range(0, THREADS, WARP):
            w, b, r0 = warp_of(block, thread, groups, group)
            if w >= warps:
                continue
            seen[b, r0:min(r0 + group, runs)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("density", DENSITIES)
def test_model_is_plain_bitwise(density, layout):
    widths = set()
    for seed, shape in enumerate(SHAPES):
        hit = make_hits(shape, density, layout, seed)
        _, width, group, step = walk(hit)
        widths.add(width)
        full_steps = shape[0] * -(-shape[1] // group) * -(-shape[2] // step)
        for num_slots in budgets(hit):
            want = forward_blocks.build_runs_plain(hit, num_slots)
            got, steps = model(hit, num_slots)
            assert_same(got, want)
            # The compact walk stops where its runs' ids are stored.
            assert steps <= full_steps
            if density == 0.0:
                assert steps == 0
    assert widths == ({1} if layout == "offset" else {1, 4})


def test_budget_cuts_a_run_in_the_middle():
    hit = make_hits((2, 37, 45), 0.05, "contiguous")
    num_slots = budgets(hit)[1]
    starts, counts, _, dropped = forward_blocks.build_runs_plain(hit,
                                                                 num_slots)
    n = hit.sum(dim=-1, dtype=torch.int32)
    cut = (counts[0] > 0) & (counts[0] < n[0])
    assert int(cut.sum()) == 1 and int(dropped[0]) > 0


def test_cpu_tensors_run_the_plain_version():
    hit = make_hits((2, 37, 45), 0.05, "transposed")
    before = forward_blocks.BUILD_RUNS.launches
    for num_slots in budgets(hit):
        assert_same(forward_blocks.build_runs(hit, num_slots),
                    forward_blocks.build_runs_plain(hit, num_slots))
    assert forward_blocks.BUILD_RUNS.launches == before


@pytest.mark.parametrize("bad", ["uint8", "float", "rank 2", "rank 4"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    hit = make_hits((2, 5, 9), 0.3, "contiguous")
    hit = {"uint8": hit.to(torch.uint8), "float": hit.float(),
           "rank 2": hit[0], "rank 4": hit[None]}[bad]
    with pytest.raises(ValueError, match="bool hits"):
        forward_blocks.build_runs(hit, 16)


def test_other_devices_raise():
    with pytest.raises(ValueError):
        forward_blocks.build_runs(
            torch.zeros(1, 3, 4, dtype=torch.bool, device="meta"), 8)


def test_kernel_is_registered():
    kernel = _cuda.KERNELS["build_runs"]
    assert kernel is forward_blocks.BUILD_RUNS
    assert kernel.replaces is None and kernel.source in _cuda.SOURCES
    assert kernel.argtypes == ([_cuda.ptr] * 5 + [_cuda.i32] * 3
                               + [_cuda.i64] * 3 + [_cuda.i32] * 4
                               + [_cuda.ptr])


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def on_card(hit, layout, device):
    """`hit` on the card with the same strides and the same offset in its
    storage's words."""
    if layout == "transposed":
        return hit.transpose(1, 2).contiguous().to(device).transpose(1, 2)
    if layout == "offset":
        padded = torch.zeros(*hit.shape[:2], hit.shape[2] + 1,
                             dtype=torch.bool)
        padded[..., 1:] = hit
        return padded.to(device)[..., 1:]
    return hit.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("density", DENSITIES)
def test_kernel_is_plain_bitwise(device, density, layout):
    for seed, shape in enumerate(SHAPES + ((4, 1024, 300), (2, 300, 1024))):
        hit = make_hits(shape, density, layout, seed)
        card = on_card(hit, layout, device)
        assert card.stride() == hit.stride()
        assert (forward_blocks.runs_layout(card)
                == forward_blocks.runs_layout(hit))
        for num_slots in budgets(hit):
            before = forward_blocks.BUILD_RUNS.launches
            got = forward_blocks.build_runs(card, num_slots)
            torch.cuda.synchronize()
            assert forward_blocks.BUILD_RUNS.launches == before + 2
            assert_same(got, forward_blocks.build_runs_plain(card, num_slots))
            assert_same(got, forward_blocks.build_runs_plain(hit, num_slots))
