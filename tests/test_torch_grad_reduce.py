"""The launch shape of the face-major gradient reductions (K3 grad_reduce,
K6 slot_grad_reduce) and chip_smoke's edge runs for them, on the CPU.

grad_blocks.reduce_shape decides, from the shapes and a block's opt-in
shared memory, the pixel lanes per face, the ring depth, the colour group
and the shared memory of a launch.  It must fit every shape the paths and
the tests launch: at most 1024 threads, the shared memory within the
opt-in size, groups that cover the channels.  The kernels themselves run
on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import pathlib

import pytest
import torch

from dirt_tpu_torch.ops import grad_blocks, grad_dense

REPO = pathlib.Path(__file__).resolve().parents[1]
H100_OPTIN = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on the H100


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


# (parts, channels) of every K3 / K6 launch: the direct step (3), the
# deferred G-buffer (10, fused and two-call), the card tests' 1-13.
LAUNCHES = [("all", c) for c in (1, 3, 4, 5, 10, 12, 13)] + [
    ("position", 3), ("position", 13), ("color", 3), ("color", 10),
    ("color", 13)]


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("tile", [(16, 16), (8, 128), (16, 128)])
@pytest.mark.parametrize("parts,channels", LAUNCHES)
def test_reduce_shape_fits(chunk, tile, parts, channels):
    staged = grad_dense.plane_layout(parts, channels)[0] * tile[0] * tile[1]
    s = grad_blocks.reduce_shape(chunk, staged, channels,
                                 parts != "position", H100_OPTIN)
    threads = chunk * s.lanes
    assert threads <= 1024 and s.lanes & (s.lanes - 1) == 0
    assert s.lanes == min(8, 1024 // chunk)
    assert s.smem <= H100_OPTIN and grad_blocks.VISIT_LIST >= threads
    assert s.smem == 4 * (s.region + grad_blocks.VISIT_LIST + 64)
    assert s.slot >= staged and s.slot % 4 == 0 and s.region % 4 == 0
    assert s.region >= s.depth * s.slot
    assert s.region >= (s.lanes // 2) * chunk * (9 + 3 * s.group)
    two = 4 * (max(2 * s.slot, (s.lanes // 2) * chunk * (9 + 3 * s.group))
               + grad_blocks.VISIT_LIST + 64)
    assert s.depth == (2 if two <= H100_OPTIN else 1)


@pytest.mark.parametrize("channels", range(1, 31))
def test_reduce_shape_groups_cover_channels(channels):
    s = grad_blocks.reduce_shape(32, 4096, channels, True, H100_OPTIN)
    passes = -(-channels // s.group)
    assert s.group in (4, 8, 12) and s.group * passes >= channels
    # The least group that covers the channels; past 12, passes of 12.
    assert s.group == next((g for g in (4, 8, 12) if g >= channels), 12)
    assert grad_blocks.reduce_shape(32, 4096, channels, False,
                                    H100_OPTIN).group == 4


def test_reduce_shape_at_the_bench_configuration():
    # 16x16 tiles, 32-face blocks: the direct step's 15 planes, the
    # deferred step's 22 (ten colour channels in one pass).
    direct = grad_blocks.reduce_shape(32, 15 * 256, 3, True, H100_OPTIN)
    assert direct == grad_blocks.ReduceShape(
        lanes=8, depth=2, group=4, slot=3840, region=7680, staged=3840,
        smem=35072)
    deferred = grad_blocks.reduce_shape(32, 22 * 256, 10, True, H100_OPTIN)
    assert (deferred.lanes, deferred.depth, deferred.group) == (8, 2, 12)
    assert deferred.smem == 4 * (2 * 5632 + 1024 + 64)


def test_reduce_shape_odd_sizes_and_limits():
    # An odd stack rounds its slot up; a smaller opt-in takes one slot;
    # a stack over it, or a block over 1024 threads, raises.
    odd = grad_blocks.reduce_shape(20, 15 * 35, 3, True, H100_OPTIN)
    assert odd.slot == 528 and odd.staged == 525 and odd.lanes == 8
    wide = 25 * 1024 * 4
    assert grad_blocks.reduce_shape(128, 25 * 1024, 13, True,
                                    2 * wide).depth == 1
    assert grad_blocks.reduce_shape(1024, 3840, 3, True, H100_OPTIN).lanes == 1
    assert grad_blocks.reduce_shape(200, 3840, 3, True, H100_OPTIN).lanes == 4
    with pytest.raises(ValueError, match="shared memory"):
        grad_blocks.reduce_shape(32, 64 * 1024, 3, True, H100_OPTIN)
    with pytest.raises(ValueError, match="1024 threads"):
        grad_blocks.reduce_shape(2048, 3840, 3, True, H100_OPTIN)


def test_shared_memory_layout_mirrors_the_kernels():
    # reduce_shape sizes the shared memory the kernels lay out: the ring,
    # then VISIT_LIST ids (grad_math.cuh's kVisitList), then _SCRATCH ints
    # (kScratch); the C entry points take the bytes and recompute nothing.
    csrc = REPO / "dirt_tpu_torch" / "csrc"
    header = (csrc / "grad_math.cuh").read_text()
    assert f"constexpr int kVisitList = {grad_blocks.VISIT_LIST};" in header
    assert f"constexpr int kScratch = {grad_blocks._SCRATCH};" in header
    for source in ("grad_reduce.cu", "slot_grad.cu"):
        text = (csrc / source).read_text()
        assert "kScratch" not in text and "list_cap" not in text, source
        assert "int vec16, int smem," in text, source


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_edge_runs_are_one_reduction():
    """chip_smoke's edge runs give K3 and K6 the same visits: the plain
    versions agree bit for bit, the empty run reduces to zeros, the run
    longer than a block's visit list does not."""
    from dirt_tpu_torch.ops import forward_blocks, prepass_fused
    smoke = _chip_smoke()
    background, clip, colors, faces, weights = smoke.bench_scene(
        2, 32, 16, "cpu")
    height, width = background.shape[1:3]
    pixels, aux = forward_blocks.rasterise_batch(background, clip, colors,
                                                 faces)
    planes, _ = prepass_fused.plane_stack(pixels, weights, aux, 16, 16, 16)
    table = grad_blocks.pack(clip, faces, height, width, 16, 16, 32)[0]
    csr, slot = smoke.edge_runs((table, planes, None, None, None, 3, "all"))
    assert csr[3].tolist() == [0, 1, grad_blocks.VISIT_LIST + 300, 37]
    assert int((slot[3] < 0).sum()) == 4 + sum(n // 5 for n in
                                               csr[3].tolist())
    rows = grad_blocks.grad_reduce(*csr)
    assert torch.equal(grad_blocks.slot_grad_reduce(*slot), rows)
    assert not bool(rows[0].any()) and bool(rows[2].any())


def test_chip_smoke_visited_tiles_are_the_schedules():
    """The tiles chip_smoke counts in K3's and K6's bounds: the CSR runs'
    visits, in order, are the slot schedule's live slots; each tile is
    counted once, and fewer than all are visited."""
    smoke = _chip_smoke()
    _, clip, _, faces, _ = smoke.bench_scene(2, 128, 16, "cpu")
    schedule = (clip, faces, 128, 128, 16, 16, 32)
    _, starts, counts, tile_ids, _ = grad_blocks.pack(*schedule)
    _, _, slot_item, slot_dma, _ = grad_blocks.pack(*schedule, slots=True)
    visits = smoke.csr_tiles(starts, counts, tile_ids)
    assert visits.numel() == int(counts.sum()) > 0
    assert torch.equal(visits, slot_dma[slot_item >= 0])
    distinct = int(torch.unique(visits).numel())
    assert distinct < visits.numel() and distinct < 2 * 64
    assert smoke.tile_pixels(visits, 128, 128, 16, 16) == distinct * 256
    # On a 100-pixel image the seventh tile of a row holds 4 columns, in
    # either image; a tile visited twice counts once.
    assert smoke.tile_pixels(torch.tensor([0, 5, 5, 6, 7, 49 + 6]), 100, 100,
                             16, 16) == 3 * 256 + 2 * 16 * 4
