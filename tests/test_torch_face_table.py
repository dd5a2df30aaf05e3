"""K13 face_table: both passes' face tables in Morton order, from the
vertices.

The kernel (dirt_tpu_torch/csrc/face_table.cu) takes two launches: keys
gives each face the Morton key of its bbox-centre tile (spatial_order's),
the wrapper's stable argsort orders them, and rows writes each sorted row
straight from its face's corners (or the pad row).  Here, on the CPU,
where forward_blocks.face_table runs the plain path (the unsorted table,
spatial_order, take_along_dim):

  * the plain keys (face_keys_plain, from the vertices) are the keys
    spatial_order sorts the plain table by, and their stable argsort is
    its order;
  * the plain rows in that order (face_rows_plain, each row set up from
    its face) are take_along_dim of the plain table bit for bit, NaN
    columns included, in both layouts (the forward's 27 + 3C columns and
    the gradient's 21), at the port's tile and at the JAX package's, and
    in face order (SPATIAL off);
  * over scenes with degenerate faces, corners at w <= 0 and just above
    it (huge or infinite bbox bounds), off-screen faces, a NaN vertex and
    pad rows;
  * the kernel's store walk covers each element of a block's rows once,
    in order, at every table width the cells use;
  * the CPU path launches nothing.

On the card (marked cuda; run as tests/test_torch_cuda.py says) the
kernel's keys, order and rows are the plain path's bit for bit, two
launches a table.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from dirt_tpu_torch.ops import forward_blocks, forward_pallas, grad_tables

SOURCE = (pathlib.Path(forward_blocks.__file__).resolve().parents[1]
          / "csrc" / "face_table.cu").read_text()
THREADS = 128       # face_table.cu's kThreads
HEIGHT, WIDTH = 48, 80
# The port's tile, the JAX package's fused one, and face order.
TILES = {"port": (16, 16), "jax": (4, 128), "unsorted": None}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def scene(kind, batch=2, num_faces=61, seed=0):
    """(vertices [B, V, 4], faces [B, F, 3] int32, colours [B, V, 3]) of a
    triangle soup, 3 vertices a face, with rows of `kind`."""
    rng = np.random.default_rng(seed)
    num_vertices = 3 * num_faces
    xy = rng.uniform(-1.2, 1.2, (batch, num_vertices, 2))
    z = rng.uniform(-0.5, 0.9, (batch, num_vertices, 1))
    w = rng.uniform(0.6, 2.0, (batch, num_vertices, 1))
    v = np.concatenate([xy * w, z * w, w], -1).astype(np.float32)
    f = np.tile(np.arange(num_vertices, dtype=np.int32).reshape(-1, 3),
                (batch, 1, 1))
    if kind == "degenerate":
        f[:, ::4, 2] = f[:, ::4, 1]                        # repeated vertex
        v[:, 3 * 5 + 2] = v[:, 3 * 5]                      # coincident
        v[:, 3 * 7 + 2, :2] = 2 * v[:, 3 * 7 + 1, :2] - v[:, 3 * 7, :2]
        v[:, 3 * 7 + 2, 3] = v[:, 3 * 7 + 1, 3]            # a line, maybe
    elif kind == "behind":
        v[:, 0:30:3, 3] = 0.0                              # w = 0
        v[:, 1:30:3, 3] = -v[:, 1:30:3, 3]                 # w < 0
        v[:, 30:60:3, 3] = 1e-30                           # huge px
        v[:, 61:90:3, 3] = 1e-45                           # infinite px
    elif kind == "offscreen":
        v[:, : num_vertices // 2, 0] += 5.0 * v[:, : num_vertices // 2, 3]
        v[:, num_vertices // 2:, 1] -= 3.0 * v[:, num_vertices // 2:, 3]
    elif kind == "nan":
        v[:, 4, 0] = np.nan
        v[:, 10, 3] = np.nan
    colours = rng.uniform(0, 1, (batch, num_vertices, 3)).astype(np.float32)
    return torch.as_tensor(v), torch.as_tensor(f), torch.as_tensor(colours)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("layout", ["forward", "gradient"])
@pytest.mark.parametrize("kind", ["soup", "degenerate", "behind",
                                  "offscreen", "nan"])
def test_plain_keys_and_rows_are_the_plain_table(kind, layout, tile):
    vertices, faces, colours = scene(kind)
    attrs = colours if layout == "forward" else None
    rows = 96                                              # 35 pad rows
    tile = TILES[tile]
    table_layout = forward_blocks.table_layout(attrs)
    widen = 1 if layout == "gradient" else 0
    assert table_layout.widen == widen
    unsorted = (forward_pallas._face_table(vertices, colours, faces, HEIGHT,
                                           WIDTH, rows - faces.shape[1])
                if attrs is not None else grad_tables._grad_face_table(
                    vertices, faces, HEIGHT, WIDTH, rows - faces.shape[1]))
    table, order = forward_blocks.face_table(vertices, faces, attrs, HEIGHT,
                                             WIDTH, rows, tile)
    assert table.shape == (2, rows, 21 if attrs is None else 36)
    if tile is None:
        assert torch.equal(order, torch.arange(rows).expand(2, -1).int())
        assert same_bits(table, unsorted)
    else:
        bbox = (unsorted[..., c].to(torch.int32) for c in table_layout.bbox)
        keys = forward_blocks.face_keys_plain(vertices, faces, rows, HEIGHT,
                                              WIDTH, widen, *tile)
        assert torch.equal(keys, forward_blocks.spatial_keys(*bbox, *tile))
        assert torch.equal(torch.argsort(keys, dim=-1, stable=True).int(),
                           order)
        assert torch.equal(order, forward_blocks.spatial_order(
            unsorted, table_layout.bbox, *tile))
        assert same_bits(table, torch.take_along_dim(
            unsorted, order[..., None].long(), dim=1))
        assert bool((order[:, -35:] >= faces.shape[1]).all())
    assert same_bits(forward_blocks.face_rows_plain(
        vertices, faces, attrs, rows, HEIGHT, WIDTH,
        None if tile is None else order), table)
    if kind == "nan":
        # The NaN vertex reaches the table's columns.
        assert bool(torch.isnan(table).any())


@pytest.mark.parametrize("width_d", [21, 36, 45, 57])
@pytest.mark.parametrize("rows", [1, 37, THREADS])
def test_rows_store_walk(width_d, rows):
    # face_table.cu's store loop: thread t starts at (t / D, t % D) and
    # steps kThreads elements at a time by (kThreads / D, kThreads % D)
    # with a carry; together the threads store every element once.
    assert re.search(rf"kThreads = {THREADS};", SOURCE)
    seen = []
    for t in range(THREADS):
        r, c = divmod(t, width_d)
        step_r, step_c = divmod(THREADS, width_d)
        for e in range(t, rows * width_d, THREADS):
            assert (r, c) == divmod(e, width_d)
            seen.append(e)
            r, c = r + step_r, c + step_c
            if c >= width_d:
                r, c = r + 1, c - width_d
    assert sorted(seen) == list(range(rows * width_d))


def test_cpu_launches_nothing():
    vertices, faces, colours = scene("soup")
    forward_blocks.FACE_TABLE.launches = 0
    forward_blocks.pack(vertices, colours, faces, HEIGHT, WIDTH, 16, 16, 32)
    forward_blocks.pack(vertices, colours, faces, HEIGHT, WIDTH, 16, 16, 32,
                        slots=True)
    forward_pallas._pack_faces(vertices, colours, faces, HEIGHT, WIDTH, 2, 3,
                               5, 32, 16, 16)
    assert forward_blocks.FACE_TABLE.launches == 0
