"""The run walk of K7 dense_sweep, K8 pallas_raster and K5 resident_sweep,
on the CPU.

The three kernels sweep with sweep_math.cuh's sweep_run, K1's walk
(tests/test_torch_sweep_split.py holds its argument for the block
schedule).  K7 and K8 deal a tile's face list to S face groups (list
entry v to group v mod S), sweep each group's share into its own winners
and combine them in group order by the lexicographic (depth, original
index) test; a face is tested only where its pixel bbox holds the pixel.
K5 stages the image's table once for a block of RESIDENT_TILES tiles
that holds a visit, and sweeps each tile as K1 does.  Here, on the plain
side:

  * K8's argument: each group's share of the lists swept by
    forward_pallas._visibility_plain, the groups' winners combined in the
    kernel's order and in every other order, against _visibility_plain
    over the whole lists, on a camera-crossing soup and the 100x100 bench
    scene;
  * K7's: each group's share swept by forward_dense.dense_sweep_plain one
    listed face a visit (no live-chunk tail), the groups' states combined
    in the kernel's order, against dense_sweep_plain over the whole lists
    in every state row, the pixels of the padded tile grid past the image
    edge included; its winners are _visibility_plain's;
  * the cull: each _visibility_plain winner's pixel bbox holds its pixel,
    past the image edge too (the pixel clamped to the image, as the bbox
    is);
  * K5's blocks: resident_sweep_plain's state does not depend on the
    tiles a block takes (groups swept apart and joined);
  * the launch shapes (sweep_shape at one face a visit, resident_shape)
    and the constants, argument counts and kernel names that mirror the
    CUDA sources.

The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import functools
import itertools
import pathlib
import re
import sys

import pytest
import torch

from dirt_tpu_torch.ops import (_cuda, forward_blocks, forward_dense,
                                forward_pallas)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

H100_OPTIN = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on the H100
CSRC = REPO / "dirt_tpu_torch" / "csrc"


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
    "crossing 2x100^2": lambda: chip_smoke.crossing_scene("cpu",
                                                          size=100)[:4],
    "bench 4x100^2": lambda: chip_smoke.bench_scene(4, 100, 64, "cpu")[:4],
    "bench 2x64^2": lambda: chip_smoke.bench_scene(2, 64, 16, "cpu")[:4],
}
LISTS = ("crossing 2x100^2", "bench 4x100^2")
BLOCKS = ("crossing 2x100^2", "bench 2x64^2")


@functools.lru_cache(maxsize=None)
def _list_inputs(name):
    """_visibility_plain's arguments on the dense packing of scene
    `name` (the GPU tile, 16x16, and chunk), and its winners over the
    whole lists."""
    background, clip, colors, faces = SCENES[name]()
    _, height, width, _ = background.shape
    th, tw = forward_dense.tile_shape(height, width)
    tiles_x = -(-width // tw)
    num_tiles = -(-height // th) * tiles_x
    table, face_ids, counts, _ = forward_dense.pack(
        clip, colors, faces, height, width, th, tw, forward_dense.CHUNK)
    args = (table, face_ids, counts, height, width, tiles_x, num_tiles, th,
            tw, forward_dense.CHUNK)
    return args, _winners(args, face_ids, counts)


def _winners(args, face_ids, counts):
    """(depth, original index, table row) [R, PIX] of _visibility_plain on
    the lists `face_ids`, `counts`: (1.0, -1, -1) where none covers."""
    table = args[0]
    row, depth = forward_pallas._visibility_plain(table, face_ids, counts,
                                                  *args[3:])
    orig = torch.where(row >= 0, table[row.clamp(min=0), 19], -1.0)
    return depth, orig, row


def _group_winners(args, groups):
    """Each face group's winners: group g sweeps entries g, g + S, ... of
    every tile's list, as sweep_run deals a list."""
    face_ids, counts = args[1], args[2]
    return [_winners(args, face_ids[:, g::groups].contiguous(),
                     ((counts - g + groups - 1) // groups).clamp(min=0))
            for g in range(groups)]


def _combine(winners, order):
    """sweep_math.cuh's combine_groups: the first group's winners take
    each other group's in turn where it is nearer, or as near with a
    smaller original index."""
    depth, orig, row = winners[order[0]]
    for g in order[1:]:
        d, o, r = winners[g]
        better = (d < depth) | ((d == depth) & (o < orig))
        depth = torch.where(better, d, depth)
        orig = torch.where(better, o, orig)
        row = torch.where(better, r, row)
    return depth, orig, row


@pytest.mark.parametrize("name", LISTS)
def test_list_groups_combine_to_the_plain_winners(name):
    args, want = _list_inputs(name)
    assert int((want[2] >= 0).sum()) > 200
    groups = forward_blocks.sweep_shape(256, 1, H100_OPTIN).groups
    assert groups == 2
    # The kernel's two groups, and three on the soup (any partition).
    for parts in (groups, 3) if name.startswith("crossing") else (groups,):
        winners = _group_winners(args, parts)
        for order in itertools.permutations(range(parts)):
            got = _combine(winners, order)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (parts, order)


def _combine_states(states, order, channels):
    """combine_groups on whole states [R, C+9, PIX]: the first group's
    pixels take each other group's state where its winner is nearer, or
    as near with a smaller original index."""
    state = states[order[0]]
    for g in order[1:]:
        other = states[g]
        d, o = other[:, channels + 7], other[:, channels + 8]
        depth, orig = state[:, channels + 7], state[:, channels + 8]
        better = (d < depth) | ((d == depth) & (o < orig))
        state = torch.where(better[:, None], other, state)
    return state


@pytest.mark.parametrize("name", LISTS)
def test_dense_groups_combine_to_the_plain_state(name):
    args, (depth, orig, _) = _list_inputs(name)
    table, face_ids, counts, height, width, tiles_x, num_tiles, th, tw, \
        chunk = args
    channels = (table.shape[1] - forward_pallas._BASE) // 3
    geometry = (channels, height, width, tiles_x, num_tiles, th, tw)
    want = forward_dense.dense_sweep_plain(table, face_ids, counts,
                                           *geometry, chunk)
    # dense_sweep_plain picks _visibility_plain's winners, past the image
    # edge too, so the cull's premise (test_list_winners_lie_in_their_bbox)
    # is K7's.
    assert torch.equal(want[:, channels + 7], depth)
    assert torch.equal(want[:, channels + 8], orig)
    groups = forward_blocks.sweep_shape(th * tw, 1, H100_OPTIN).groups
    # Group g's share, one listed face a visit (chunk 1: only the listed
    # entries, as the kernel tests them).
    states = [forward_dense.dense_sweep_plain(
        table, face_ids[:, g::groups].contiguous(),
        ((counts - g + groups - 1) // groups).clamp(min=0), *geometry, 1)
        for g in range(groups)]
    got = _combine_states(states, range(groups), channels)
    assert torch.equal(got, want)
    # The padded grid overhangs the 100-pixel images: the rows and columns
    # past the edge are in the state, and on the soup some are covered.
    runs, pix = depth.shape
    tile = torch.arange(runs) % num_tiles
    p = torch.arange(pix)
    past = ((((tile // tiles_x) * th)[:, None] + p // tw >= height)
            | (((tile % tiles_x) * tw)[:, None] + p % tw >= width))
    assert bool(past.any())
    if name.startswith("crossing"):
        assert bool((orig[past] >= 0).any())


@pytest.mark.parametrize("name", LISTS)
def test_list_winners_lie_in_their_bbox(name):
    args, (_, _, row) = _list_inputs(name)
    table, _, _, height, width, tiles_x, num_tiles, th, tw, _ = args
    runs, pix = row.shape
    tile = torch.arange(runs) % num_tiles
    p = torch.arange(pix)
    rows = ((tile // tiles_x) * th)[:, None] + p // tw
    cols = ((tile % tiles_x) * tw)[:, None] + p % tw
    past = (rows >= height) | (cols >= width)
    covered = row >= 0
    r = rows.clamp(max=height - 1)[covered].float()
    c = cols.clamp(max=width - 1)[covered].float()
    box = table[row[covered]][:, list(forward_blocks._BBOX)]
    assert bool(((box[:, 0] <= r) & (r <= box[:, 1]) & (box[:, 2] <= c)
                 & (c <= box[:, 3])).all())
    if name.startswith("crossing"):
        # Faces through the camera plane have the whole screen as their
        # bbox and cover pixels of the padded grid past the image edge.
        assert int((covered & past).sum()) > 0


@functools.lru_cache(maxsize=None)
def _resident(name):
    """resident_sweep_plain's arguments on scene `name` (the block
    schedule's GPU shape) and its state."""
    background, clip, colors, faces = SCENES[name]()
    _, height, width, channels = background.shape
    th = tw = forward_blocks.TILE_H
    tiles_x = -(-width // tw)
    num_tiles = -(-height // th) * tiles_x
    table, starts, counts, block_ids, _ = forward_blocks.pack(
        clip, colors, faces, height, width, th, tw, forward_blocks.CHUNK)
    args = (table, starts, counts, block_ids, channels, height, width,
            tiles_x, num_tiles, th, tw)
    return args, forward_blocks.resident_sweep_plain(*args)


@pytest.mark.parametrize("tiles", sorted({1, 2, 4, 8, 3,
                                          forward_blocks.RESIDENT_TILES}))
@pytest.mark.parametrize("name", BLOCKS)
def test_resident_state_is_independent_of_the_tiles_a_block_takes(name,
                                                                  tiles):
    args, want = _resident(name)
    table, starts, counts, block_ids, channels = args[:5]
    geometry = args[4:]
    num_tiles, th, tw = args[8:]
    # The block of each run: an image's tiles in groups of `tiles`, the
    # last group ragged, as resident_sweep.cu's grid.
    runs = torch.arange(counts.numel())
    per_image = -(-num_tiles // tiles)
    block = (runs // num_tiles) * per_image + (runs % num_tiles) // tiles
    # Alternate blocks swept apart, then joined.
    even = block % 2 == 0
    part = [forward_blocks.resident_sweep_plain(
        table, starts, torch.where(even == keep, counts, 0), block_ids,
        *geometry) for keep in (True, False)]
    assert torch.equal(torch.where(even[:, None, None], *part), want)
    # A block without a visit writes the background.
    live = torch.zeros(int(block.max()) + 1, dtype=torch.bool)
    live[block[counts > 0]] = True
    empty = ~live[block]
    init = forward_dense.init_state(channels, th * tw)
    assert bool(live.any()) and (bool(empty.any()) or name.startswith(
        "crossing"))
    assert torch.equal(want[empty], init.expand(int(empty.sum()), -1, -1))


def test_list_walk_shape():
    # K8's lists at one face a visit: two groups of 256 threads, a list
    # piece of 512 ids, staging for 573 faces (so a piece goes in at once,
    # one barrier), three blocks an SM as K1's.
    s = forward_blocks.sweep_shape(256, 1, H100_OPTIN)
    assert s == forward_blocks.SweepShape(groups=2, threads=512, cap=573,
                                          region=13752, list=512,
                                          smem=57312)
    assert s.cap >= s.list
    assert (forward_blocks.SWEEP_BLOCKS * (s.smem + 1024)
            <= forward_blocks.SM_SHARED_BYTES)
    for pix in (35, 64, 100, 256, 512, 1024):
        s = forward_blocks.sweep_shape(pix, 1, H100_OPTIN)
        assert s.smem <= H100_OPTIN and s.cap >= 2


def test_resident_shape():
    # The bench's 512 faces and the 1,536-face table: the combine's
    # winners (256 x 7 words), the visit list, then 24 floats a face.
    bench = forward_blocks.resident_shape(256, 512, H100_OPTIN)
    assert bench == forward_blocks.ResidentShape(
        groups=2, threads=512, region=1792, list=512, table_at=2304,
        smem=58368)
    assert forward_blocks.resident_shape(256, 1536, H100_OPTIN).smem == 156672
    with pytest.raises(ValueError, match="shared memory"):
        forward_blocks.resident_shape(256, 10000, H100_OPTIN)
    for pix in (35, 64, 100, 256, 512, 1024):
        for channels in (1, 3, 10):
            # The largest table takes_resident admits at auto (its whole
            # rows) fits with its leading columns staged.
            width_d = forward_pallas._BASE + 3 * channels
            faces = H100_OPTIN // (4 * width_d)
            s = forward_blocks.resident_shape(pix, faces, H100_OPTIN)
            assert s.table_at % 4 == 0
            assert s.table_at >= s.region + s.list
            assert s.region >= (s.groups - 1) * pix * 7
            assert s.smem == 4 * (s.table_at
                                  + faces * forward_blocks.FACE_FLOATS)
            assert s.smem <= H100_OPTIN


def test_list_walk_constants_mirror_the_kernels():
    resident = (CSRC / "resident_sweep.cu").read_text()
    assert re.search(rf"constexpr int kResidentTiles = "
                     rf"{forward_blocks.RESIDENT_TILES};", resident)
    pallas = (CSRC / "pallas_raster.cu").read_text()
    dense = (CSRC / "dense_sweep.cu").read_text()
    for kernel in (pallas, resident, dense):
        assert "dirt::sweep_run(" in kernel
        assert "__launch_bounds__(kMaxThreads, kMinBlocks)" in kernel
        assert "threads <= dirt::kSweepThreads" in kernel
        assert "dirt::kSweepBlocks>" in kernel and "<1024, 1>" in kernel
    for kernel in (pallas, dense):
        assert "dirt::CsrFill fill{" in kernel
        assert "dirt::StagedFaces<true>{table, 1, width_d}" in kernel
    assert "dirt::StateEpilogue out{" in dense
    # K7 was the last caller of the one-thread-a-pixel list walk: every
    # forward sweep is on sweep_run, and sweep_list is gone.
    assert not [path.name for path in sorted(CSRC.glob("*.cu*"))
                if "sweep_list" in path.read_text()]
    assert forward_pallas.PALLAS_RASTER.argtypes.count(_cuda.i32) == 16
    assert forward_dense.DENSE_SWEEP.argtypes.count(_cuda.i32) == 16
    assert forward_blocks.RESIDENT_SWEEP.argtypes.count(_cuda.i32) == 17
    # K4's launch shape (threads a thread block where a block's faces fit
    # a warp, the largest chunk), from which its launcher sizes the grid,
    # and its arguments: table, hits and window counter, then the
    # geometry (no grid).
    hit = (CSRC / "hit_plane.cu").read_text()
    assert re.search(rf"constexpr int kHitThreads = "
                     rf"{forward_blocks.HIT_THREADS};", hit)
    assert re.search(rf"constexpr int kMaxChunk = "
                     rf"{forward_blocks.HIT_MAX_CHUNK};", hit)
    assert "const int threads = chunk > kWarp ? chunk : kHitThreads;" in hit
    assert "(num_faces + threads - 1) / threads" in hit
    assert forward_blocks.HIT_PLANE.argtypes[:3] == [_cuda.ptr] * 3
    assert forward_blocks.HIT_PLANE.argtypes.count(_cuda.i32) == 15


def test_device_kernel_names():
    # chip_smoke.py reads each kernel's device time by the name of its
    # __global__ function: every wrapper has one, in its own source.
    import dirt_tpu_torch.ops.grad_blocks  # noqa: F401
    import dirt_tpu_torch.ops.grad_dense  # noqa: F401
    import dirt_tpu_torch.ops.grad_mxu  # noqa: F401
    import dirt_tpu_torch.ops.prepass_fused  # noqa: F401
    import dirt_tpu_torch.repro.scalar_accum  # noqa: F401
    assert set(chip_smoke.DEVICE_KERNELS) == set(_cuda.KERNELS)
    for name, symbol in chip_smoke.DEVICE_KERNELS.items():
        text = (CSRC / _cuda.KERNELS[name].source).read_text()
        assert re.search(rf"__global__ void[^;{{]*?\b{symbol}\(", text), name
