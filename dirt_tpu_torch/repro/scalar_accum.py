"""Scalar accumulation of masked vector reductions (PyTorch port of the
kernel of repro/mosaic_scalar_smem_accum.py, a minimised repro of a Mosaic
miscompile).

The pattern: a grid of (tiles, chunks) steps; step (t, c) loops over its
n_live = min(chunk, count[t] - c * chunk) rows, a dynamic bound, and adds
four masked sums over tile t's pixels into row j of an output that starts
at zero (the TPU aliases a zeros input to it):

    mask = ids_plane == ids[t, c * chunk + j]
    out[t, c, j] += (sum(a * mask), sum(b * mask), sum(a * b * mask),
                     -sum(b * a * mask))

scalar_accum runs it as the CUDA kernel K11 on CUDA tensors (the wrapper
zero-fills the output, the kernel adds into it) and as its plain version,
a vectorised port of the repro's `reference`, on CPU tensors.
repro_inputs builds the repro's inputs from a numpy seed.

K11 takes a block of ACCUM_WARPS warps per tile (csrc/scalar_accum.cu's
kAccumWarps), warp w the tile's live rows w, w + ACCUM_WARPS, ..., over
the tile's pixels in passes of 32 * ACCUM_IDS_PER_LANE (kIdsPerLane: the
pixel ids a lane holds in registers).
"""

import numpy as np
import torch

from ..ops import _cuda

TILE_H, TILE_W = 8, 128
CHUNK = 16
TILES = 4
CHUNKS = 2
D = 4
ACCUM_WARPS = 16
ACCUM_IDS_PER_LANE = 32

SCALAR_ACCUM = _cuda.Kernel(
    "scalar_accum", "dirt_scalar_accum",
    [_cuda.ptr] * 4 + [_cuda.i32] * 3 + [_cuda.ptr],
    replaces="repro/mosaic_scalar_smem_accum.py:55",
    source="scalar_accum.cu")


def repro_inputs(tiles=TILES, chunks=CHUNKS, chunk=CHUNK, tile_h=TILE_H,
                 tile_w=TILE_W, seed=0, random_counts=False):
    """(planes [T, 3, H, W] f32, ids [T, 1, N] f32, counts [T, 1, 1, 1]
    int32) as the repro's `run` builds them: planes 0 and 1 normal, plane
    2 the per-pixel ids in [0, N), ids 0..N-1 on every tile and counts N;
    with `random_counts`, each tile's count is drawn from [0, N] after
    the planes (its later chunks and rows are then dead)."""
    rng = np.random.RandomState(seed)
    num_ids = chunks * chunk
    planes = rng.randn(tiles, 3, tile_h, tile_w).astype(np.float32)
    planes[:, 2] = rng.randint(0, num_ids, size=(tiles, tile_h, tile_w))
    ids = np.tile(np.arange(num_ids, dtype=np.float32)[None, None],
                  (tiles, 1, 1))
    counts = np.full((tiles, 1, 1, 1), num_ids, np.int32)
    if random_counts:
        counts[:, 0, 0, 0] = rng.randint(0, num_ids + 1, size=tiles)
    return planes, ids, counts


def _flat(planes, ids, counts, chunk):
    tiles = planes.shape[0]
    ids = ids.reshape(tiles, -1)
    if ids.shape[1] % chunk:
        raise ValueError(f"{ids.shape[1]} ids do not split into chunks of "
                         f"{chunk}")
    return planes.reshape(tiles, 3, -1), ids, counts.reshape(tiles)


def scalar_accum_plain(planes, ids, counts, chunk):
    """The rows [T, N / chunk, chunk, 4]: row n of tile t holds the four
    masked sums of id ids[t, n] when n < counts[t], else zeros."""
    planes, ids, counts = _flat(planes, ids, counts, chunk)
    tiles, num_ids = ids.shape
    a, b, pid = planes[:, 0:1], planes[:, 1:2], planes[:, 2:3]   # [T,1,PIX]
    mask = pid == ids[..., None]                                 # [T,N,PIX]
    ma = torch.where(mask, a, 0.0)
    mb = torch.where(mask, b, 0.0)
    sums = torch.stack([ma.sum(-1), mb.sum(-1), (ma * b).sum(-1),
                        -(mb * a).sum(-1)], dim=-1)              # [T, N, 4]
    live = (torch.arange(num_ids, device=ids.device)[None]
            < counts.long()[:, None])
    sums = torch.where(live[..., None], sums, 0.0)
    return sums.reshape(tiles, num_ids // chunk, chunk, D)


def scalar_accum(planes, ids, counts, chunk=CHUNK):
    """K11 wrapper: scalar_accum_plain's rows, by the CUDA kernel for CUDA
    tensors and by the plain version for CPU tensors.

    planes [T, 3, ...] f32 (a, b, per-pixel ids); ids [T, 1, N] or [T, N]
    f32, N a multiple of `chunk`; counts [T, ...] int32, one per tile."""
    if not _cuda.on_cuda(planes, ids, counts):
        return scalar_accum_plain(planes, ids, counts, chunk)
    planes, ids, counts = (t.contiguous() for t in _flat(planes, ids,
                                                         counts, chunk))
    tiles, num_ids = ids.shape
    chunks = num_ids // chunk
    out = torch.zeros(tiles, chunks, chunk, D, device=planes.device)
    SCALAR_ACCUM(
        _cuda.check("planes", planes, torch.float32),
        _cuda.check("ids", ids, torch.float32),
        _cuda.check("counts", counts, torch.int32, (tiles,)),
        _cuda.check("out", out, torch.float32),
        tiles, planes.shape[-1], num_ids, _cuda.stream())
    return out
