"""K10 mxu_grad's launch shape, on the CPU.

grad_mxu.mxu_shape decides how many of a band's list chunks one block
serves (all of them where the block's WARPS * TILES m16 row tiles hold
their 2 * chunk mask rows each) and the shared memory (the ring of DEPTH
stages or the partial rows of the cluster of SPLIT blocks over which a
band's pixels are split).  It must fit every shape the paths and the card
tests launch, and mirror mxu_grad.cu's constants.
The kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import pathlib

import pytest
import torch

from dirt_tpu_torch.ops import grad_mxu

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


@pytest.mark.parametrize("num_chunks", [1, 2, 4, 64])
@pytest.mark.parametrize("chunk", [16, 32, 48, 64, 128, 256, 512])
def test_mxu_shape_fits(chunk, num_chunks):
    s = grad_mxu.mxu_shape(chunk, num_chunks, H100_OPTIN)
    tiles = 2 * chunk // 16                       # m16 row tiles a chunk
    most = grad_mxu.WARPS * grad_mxu.TILES // tiles
    assert s.chunks == min(num_chunks, most) >= 1
    assert s.chunks * tiles <= grad_mxu.WARPS * grad_mxu.TILES
    ring = grad_mxu.DEPTH * grad_mxu.STAGE_BYTES
    assert s.smem == (max(ring, grad_mxu.COMBINE_BYTES)
                      + grad_mxu.TABLE_BYTES)
    assert s.smem <= H100_OPTIN
    # Blocks a band: one wherever the block holds the band's chunks.
    assert (-(-num_chunks // s.chunks) == 1) == (num_chunks <= most)


def test_mxu_shape_at_the_bench_configuration():
    # 128-face chunks, 4 a band (512 faces): all of a band's chunks in
    # each block of a cluster of two, the 131,072 bytes of partial rows
    # in the place of four stages of 14,336 bytes, and the 4,160-byte
    # table; the 8,192-face scene's 64 chunks a band in groups of four.
    assert (grad_mxu.SPLIT, grad_mxu.DEPTH) == (2, 4)
    assert grad_mxu.mxu_shape(128, 4, H100_OPTIN) == grad_mxu.MxuShape(
        chunks=4, smem=135232)
    assert grad_mxu.mxu_shape(128, 64, H100_OPTIN) == grad_mxu.MxuShape(
        chunks=4, smem=135232)


def test_mxu_shape_limits():
    with pytest.raises(ValueError, match="multiple of 16"):
        grad_mxu.mxu_shape(24, 4, H100_OPTIN)
    with pytest.raises(ValueError, match="at most 512"):
        grad_mxu.mxu_shape(1024, 1, H100_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        grad_mxu.mxu_shape(128, 4, grad_mxu.COMBINE_BYTES)


@pytest.mark.parametrize("channels", range(1, 31))
def test_columns_take_n8_tiles(channels):
    # 18 + 3C columns in passes of 32 (four n8 tiles): fewer than 8
    # padded columns, the bench's 27 in one pass of 32.
    ncols = 18 + 3 * channels
    padded = sum(-(-min(32, ncols - c0) // 8) * 8
                 for c0 in range(0, ncols, 32))
    assert 0 <= padded - ncols < 8
    assert (padded == 32) == (channels == 3 or channels == 4)


def test_mxu_layout_mirrors_the_kernel():
    text = (REPO / "dirt_tpu_torch" / "csrc" / "mxu_grad.cu").read_text()
    assert f"constexpr int kWarps = {grad_mxu.WARPS};" in text
    assert f"constexpr int kTiles = {grad_mxu.TILES};" in text
    assert f"// {grad_mxu.STAGE_BYTES}" in text
    assert f"// {grad_mxu.TABLE_BYTES}" in text
    assert f"// {grad_mxu.COMBINE_BYTES}" in text
    assert f"constexpr int kSplit = {grad_mxu.SPLIT};" in text
    assert f"constexpr int kDepth = {grad_mxu.DEPTH};" in text
    assert "constexpr int kN8 = 4;" in text and "kSlice = 64;" in text
    assert ("int pix, int ncols, int chunks, int smem,\n"
            "                             cudaStream_t stream)") in text
    # No mask tile in shared memory: the fragments are built in registers;
    # one thread a face in the block's sort.
    assert "mask2(" in text and "wmma" not in text
    assert "kMaxFaces = kWarps * kTiles * 8;" in text
    assert grad_mxu.MXU_GRAD.argtypes.count(grad_mxu._cuda.i32) == 7
