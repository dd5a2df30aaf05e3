"""K4 hit_plane's face-resident tile loop, on the CPU.

The kernel (dirt_tpu_torch/csrc/hit_plane.cu) runs a block of HIT_FACES
threads, one face each, over a group of HIT_TILES tiles of one image, on
a one-dimensional grid it sizes itself: the group's tile constants are
computed once per tile, each face's columns and margins once, and the
tiles are looped over.  Here, on the plain side:

  * the decomposition: the launcher's grid and the kernel's index
    arithmetic, mirrored, write every (image, tile, face) of the plane
    exactly once, at ragged sizes and past 65,535 images too;
  * the hoisting: hit_plane_plain computed tile by tile from per-tile
    constants and per-face columns, as the kernel does, is bitwise
    hit_plane_plain, at dilate 0 and 1, with and without the edge cull,
    on the forward and the gradient face tables.

The kernel itself runs on the card (tests/test_torch_cuda.py), where its
plane is held to hit_plane_plain's bit for bit.
"""

import functools
import pathlib
import sys

import pytest
import torch

from dirt_tpu_torch.ops import (forward_blocks, forward_pallas, grad_blocks,
                                grad_tables)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


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


def hit_grid(batch, num_tiles, num_faces):
    """dirt_hit_plane's grid: blocks in one dimension, face blocks of
    HIT_FACES faces fastest, then tile groups of HIT_TILES tiles, then
    images."""
    face_blocks = _cdiv(num_faces, forward_blocks.HIT_FACES)
    tile_groups = _cdiv(num_tiles, forward_blocks.HIT_TILES)
    return face_blocks * tile_groups * batch, face_blocks, tile_groups


def _writes(batch, num_tiles, num_faces):
    """How often hit_plane.cu's blocks write each entry of the [B, T, F]
    plane: block x of hit_grid, thread `lane`, takes face
    (x % face_blocks) * HIT_FACES + lane (none past the last face) of
    image x // face_blocks // tile_groups and writes tiles t0 .. t0 +
    min(HIT_TILES, T - t0), t0 = (x // face_blocks % tile_groups) *
    HIT_TILES; every block and lane at once (a lane past F, or a tile
    past T, of a single block or group writes nothing, so the mirror has
    none)."""
    blocks, face_blocks, tile_groups = hit_grid(batch, num_tiles,
                                                num_faces)
    x = torch.arange(blocks, dtype=torch.int64)[:, None, None]
    lane = torch.arange(min(forward_blocks.HIT_FACES, num_faces))
    i = torch.arange(min(forward_blocks.HIT_TILES, num_tiles))
    lane, i = lane[None, :, None], i[None, None, :]
    group = x // face_blocks
    f = (x % face_blocks) * forward_blocks.HIT_FACES + lane
    t0 = (group % tile_groups) * forward_blocks.HIT_TILES
    b = group // tile_groups
    live = (f < num_faces) & (i < num_tiles - t0)
    index = ((b * num_tiles + t0 + i) * num_faces + f)[live]
    writes = torch.zeros(batch * num_tiles * num_faces, dtype=torch.int32)
    writes.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))
    return writes.reshape(batch, num_tiles, num_faces)


@pytest.mark.parametrize("batch,num_tiles,num_faces", [
    (16, 256, 512),      # the bench
    (1, 256, 8192),      # the large scene
    (16, 256, 1536),     # the 1,536-face scene
    (3, 37, 300),        # F, T ragged against the block and the group
    (1, 5, 129),         # fewer tiles than a group, one face past a block
    (2, 16, 1),          # one face
    (1, 1, 1),           # one tile, one face
    (1, 16, 128),        # exactly one block and one group
    (2, 17, 128),        # one tile past a group
    (4, 32, 127),        # one face short of a block
    (70000, 1, 3),       # more images than a grid's y or z may hold
    (66000, 17, 1),      # and past 65,535 tile groups
])
def test_hit_grid_writes_every_entry_once(batch, num_tiles, num_faces):
    blocks = hit_grid(batch, num_tiles, num_faces)[0]
    assert blocks < 2 ** 31
    assert torch.equal(_writes(batch, num_tiles, num_faces),
                       torch.ones(batch, num_tiles, num_faces,
                                  dtype=torch.int32))


def test_hit_grid_fills_the_card_at_the_bench():
    # 1,024 blocks of 128 threads at the bench and on the large scene.
    assert hit_grid(16, 256, 512) == (1024, 4, 16)
    assert hit_grid(1, 256, 8192) == (1024, 64, 16)
    assert hit_grid(16, 256, 1536) == (3072, 12, 16)
    assert forward_blocks.HIT_TILES <= forward_blocks.HIT_FACES


def hit_plane_tile_loop(face_data, bbox_cols, tiles_y, tiles_x, tile_h,
                        tile_w, edge_cols, height, width, dilate):
    """hit_plane_plain in hit_plane.cu's order: each tile's constants once
    ([T] f32: the bbox bounds and the dilated rectangle's NDC corners),
    each face's columns and margins once ([B, F]), then the tiles one by
    one: the bbox compares, and the edge test where they pass."""
    num_tiles = tiles_y * tiles_x
    t = torch.arange(num_tiles, dtype=torch.int32)
    tile_r0 = ((t // tiles_x) * tile_h).float()
    tile_c0 = ((t % tiles_x) * tile_w).float()
    r_end = tile_r0 + (tile_h - 1)
    c_end = tile_c0 + (tile_w - 1)
    c_lo = tile_c0 - dilate
    c_hi = (c_lo + (tile_w - 1)) + 2 * dilate
    r_lo = tile_r0 - dilate
    r_hi = (r_lo + (tile_h - 1)) + 2 * dilate
    x_lo = (c_lo + 0.5) * (2.0 / width) - 1.0
    x_hi = (c_hi + 0.5) * (2.0 / width) - 1.0
    y_hi = 1.0 - (r_lo + 0.5) * (2.0 / height)
    y_lo = 1.0 - (r_hi + 0.5) * (2.0 / height)

    r0, r1, c0, c1 = (face_data[..., c] for c in bbox_cols)   # [B, F]
    edges = []
    if edge_cols is not None:
        for e in range(3):
            a, b, c = (face_data[..., edge_cols + 3 * e + k]
                       for k in range(3))
            margin = ((a.abs() + b.abs()) + c.abs()) * (2.0 ** -20)
            edges.append((a, b, c, margin))
    batch, num_faces = r0.shape
    keep = torch.empty(batch, num_tiles, num_faces)
    for i in range(num_tiles):
        k = ((r0 <= r_end[i]) & (r1 >= tile_r0[i]) & (c0 <= c_end[i])
             & (c1 >= tile_c0[i]))
        if edges:
            any_max_neg = torch.zeros_like(k)
            any_min_pos = torch.zeros_like(k)
            for a, b, c, margin in edges:
                a_pos, b_pos = a > 0, b > 0
                ax_max = a * torch.where(a_pos, x_hi[i], x_lo[i])
                ax_min = a * torch.where(a_pos, x_lo[i], x_hi[i])
                by_max = b * torch.where(b_pos, y_hi[i], y_lo[i])
                by_min = b * torch.where(b_pos, y_lo[i], y_hi[i])
                any_max_neg = any_max_neg | ((by_max + (ax_max + c))
                                             < -margin)
                any_min_pos = any_min_pos | ((by_min + (ax_min + c))
                                             > margin)
            # The edge test decides only where the bbox compares pass.
            k = torch.where(k, ~(any_max_neg & any_min_pos), k)
        keep[:, i] = k.float()
    return keep


SCENES = {
    "bench 2x64^2": lambda: chip_smoke.bench_scene(2, 64, 16, "cpu")[:4],
    "crossing 2x100^2": lambda: chip_smoke.crossing_scene("cpu",
                                                          size=100)[:4],
}


@functools.lru_cache(maxsize=None)
def _tables(name):
    """The forward face table (bbox columns 20-23, edge coefficients from
    column 0) and the gradient one (bbox 0-3, edges from 12) of scene
    `name`, [B, F, D] each, padded by 40 rows past the faces."""
    background, clip, colors, faces = SCENES[name]()
    height, width = background.shape[1:3]
    forward = forward_pallas._face_table(clip, colors, faces, height, width,
                                         40)
    grad = grad_tables._grad_face_table(clip, faces, height, width, 40)
    return height, width, {"forward": (forward, forward_blocks._BBOX, 0),
                           "grad": (grad, grad_blocks._BBOX, 12)}


def test_tile_loop_is_bitwise_the_plain_plane():
    for name in sorted(SCENES):
        height, width, tables = _tables(name)
        for table in ("forward", "grad"):
            face_data, bbox_cols, edge_col = tables[table]
            for edges in (True, False):
                for dilate in (0, 1):
                    args = (face_data, bbox_cols, _cdiv(height, 16),
                            _cdiv(width, 16), 16, 16,
                            edge_col if edges else None, height, width,
                            dilate)
                    want = forward_blocks.hit_plane_plain(*args)
                    got = hit_plane_tile_loop(*args)
                    assert torch.equal(got, want), (name, table, edges,
                                                    dilate)
                    # Both outcomes occur, and the cull drops pairs the
                    # bbox keeps.
                    assert 0 < int(want.sum()) < want.numel()
                    if edges:
                        bbox_only = forward_blocks.hit_plane_plain(
                            *args[:6], None, *args[7:])
                        assert int(bbox_only.sum()) > int(want.sum())
