"""dirt_tpu_torch.repro.scalar_accum (kernel K11's module) against the
Mosaic repro it ports, repro/mosaic_scalar_smem_accum.py, on the CPU.

The repro is loaded from its file, unedited.  The port's inputs must be
the repro's, and the plain version (a vectorised port of the repro's
`reference`) must agree with the reference and with the repro's kernel in
Pallas interpret mode within max |a - b| / max(max |a|, 1) <= 1e-5
(float32 sums in another order; the repro itself allows 1e-3).  With
counts below N, rows past a tile's count stay zero, as the kernel's
dynamic loop bound leaves them.  chip_smoke.py's numpy reference and its
library form (the masks times the values in one float32 bmm) must
compute the same rows.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from dirt_tpu_torch.repro import scalar_accum


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


REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def repro():
    return _load("mosaic_scalar_smem_accum",
                 REPO / "repro" / "mosaic_scalar_smem_accum.py")


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("chip_smoke", REPO / "chip_smoke.py")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() / scale <= TOL


def _rows(planes, ids, counts, chunk=scalar_accum.CHUNK):
    return scalar_accum.scalar_accum(torch.as_tensor(planes),
                                     torch.as_tensor(ids),
                                     torch.as_tensor(counts), chunk).numpy()


def test_repro_sizes_and_inputs(repro):
    assert (scalar_accum.TILE_H, scalar_accum.TILE_W, scalar_accum.CHUNK,
            scalar_accum.TILES, scalar_accum.CHUNKS, scalar_accum.D) == (
        repro.TILE_H, repro.TILE_W, repro.CHUNK, repro.TILES, repro.CHUNKS,
        repro.D)


def test_plain_matches_repro_reference_and_interpret(repro):
    got_interpret, planes, ids = repro.run(interpret=True)
    my_planes, my_ids, counts = scalar_accum.repro_inputs()
    np.testing.assert_array_equal(my_planes, planes)
    np.testing.assert_array_equal(my_ids, ids)
    got = _rows(planes, ids, counts)
    want = repro.reference(planes, ids)
    assert np.abs(want).max() > 1.0
    _close(got, want)
    _close(got, got_interpret)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_honours_counts(repro, seed):
    planes, ids, counts = scalar_accum.repro_inputs(seed=seed,
                                                    random_counts=True)
    counts[0, 0, 0, 0] = 5          # a partial first chunk, a dead second
    got = _rows(planes, ids, counts)
    want = repro.reference(planes, ids)
    n = np.arange(want.shape[1] * want.shape[2]).reshape(want.shape[1:3])
    live = n[None] < counts.reshape(-1, 1, 1)
    _close(got, np.where(live[..., None], want, 0.0))
    assert np.count_nonzero(got[0, 1]) == 0


def test_chip_smoke_reference_and_library_form(repro, chip_smoke):
    planes, ids, counts = scalar_accum.repro_inputs(
        tiles=3, chunks=3, chunk=8, seed=4, random_counts=True)
    t = [torch.as_tensor(a) for a in (planes, ids, counts)]
    want = scalar_accum.scalar_accum_plain(*t, 8).numpy()
    _close(chip_smoke.repro_reference(planes, ids, counts, 8), want)
    _close(chip_smoke.accum_bmm(*t, 8).numpy(), want)


def test_ids_must_split_into_chunks():
    planes, ids, counts = scalar_accum.repro_inputs()
    with pytest.raises(ValueError):
        _rows(planes, ids[..., :30], counts)


def test_launch_constants_mirror_the_kernel():
    text = (REPO / "dirt_tpu_torch" / "csrc" / "scalar_accum.cu").read_text()
    for name, value in (("kAccumWarps", scalar_accum.ACCUM_WARPS),
                        ("kIdsPerLane", scalar_accum.ACCUM_IDS_PER_LANE)):
        assert re.search(rf"constexpr int {name} = {value};", text), name


def _kernel_walk(planes, ids, counts, chunk):
    """K11's schedule on the CPU: a tile's live rows dealt to ACCUM_WARPS
    warps (row r to warp r mod W, each once), its pixels in passes of 32 *
    ACCUM_IDS_PER_LANE (the last one ragged, its missing pixels' ids NaN),
    a lane's partial sums over its pixels lane + 32 k, the lanes combined,
    each pass's sums added into the zeroed row."""
    warps, per_lane = scalar_accum.ACCUM_WARPS, scalar_accum.ACCUM_IDS_PER_LANE
    step = 32 * per_lane
    tiles = planes.shape[0]
    planes = planes.reshape(tiles, 3, -1).astype(np.float32)
    ids = ids.reshape(tiles, -1)
    pix, num_ids = planes.shape[-1], ids.shape[-1]
    out = np.zeros((tiles, num_ids, scalar_accum.D), np.float32)
    owners = np.zeros((tiles, num_ids), np.int64)
    for t in range(tiles):
        live = min(int(counts.reshape(-1)[t]), num_ids)
        for warp in range(warps):
            for r in range(warp, live, warps):
                owners[t, r] += 1
                for base in range(0, pix, step):
                    seg = np.full((3, step), np.nan, np.float32)
                    n = min(step, pix - base)
                    seg[:, :n] = planes[t, :, base:base + n]
                    a, b, pid = seg.reshape(3, per_lane, 32)
                    hit = pid == ids[t, r]
                    # Only a matching pixel loads its a and b.
                    lane = np.stack([np.where(hit, v, 0.0).sum(0)
                                     for v in (a, b, a * b, b * a)])
                    out[t, r] += lane.sum(-1) * np.float32([1, 1, 1, -1])
    live = np.arange(num_ids)[None] < counts.reshape(tiles, 1)
    np.testing.assert_array_equal(owners, live.astype(np.int64))
    return out.reshape(tiles, num_ids // chunk, chunk, scalar_accum.D)


@pytest.mark.parametrize("tile_h, tile_w", [(8, 128), (8, 200), (3, 5)])
def test_kernel_walk_gives_the_plain_rows(tile_h, tile_w):
    planes, ids, counts = scalar_accum.repro_inputs(
        tiles=3, chunks=3, chunk=8, tile_h=tile_h, tile_w=tile_w, seed=6,
        random_counts=True)
    counts[1, 0, 0, 0] = 0          # a tile that retires at once
    t = [torch.as_tensor(a) for a in (planes, ids, counts)]
    _close(_kernel_walk(planes, ids, counts, 8),
           scalar_accum.scalar_accum_plain(*t, 8).numpy())
