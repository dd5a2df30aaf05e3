"""The roofline counts against chip_smoke.py's at the bench scene.

chip_smoke.py counts what the port's schedule does (K1: its (tile, face
block) visits x 32 faces x 256 pixels; K3: the planes of the tiles its
runs visit).  The benchmark counts what the inputs need (a test at each
fragment, the planes of each covered pixel), so its counts may not
exceed the schedule's, and the output bytes agree.  chip_smoke.py's
numbers at bench_scene(16, 256, 64) (numpy seed 0 rotations), from its
kernel_inputs on the CPU:"""

import numpy as np
import pytest
import torch

from bench_h100.harness import work
from bench_h100.meshes.cylinder import make_cylinder
from bench_h100.reference import forward, scene

CHIP_SMOKE_K1 = (51547484, 336199680)   # (bytes, operations)
CHIP_SMOKE_K3 = (2896736, 16538835)
BATCH, SIZE, FACES = 16, 256, 512


@pytest.fixture(scope="module")
def bench_coverage():
    """(fragments, covered pixels) of bench.py's scene: numpy seed 0's
    rotations, the benchmark's scene math, the reference's coverage."""
    rng = np.random.RandomState(0)
    vertices, faces = make_cylinder(0.5, 1.0, 0.1, 0.2, 64)
    homogeneous = torch.cat([torch.as_tensor(vertices),
                             torch.ones(len(vertices), 1)], 1)
    rotations = torch.as_tensor(
        rng.uniform(-1, 1, size=(BATCH, 3)).astype(np.float32))
    view, projection = scene.camera(0.25, 3.0, "cpu")
    clip = scene.clip_vertices(homogeneous, rotations, view, projection)
    faces = torch.as_tensor(faces).expand(BATCH, -1, -1).contiguous()
    return forward.coverage(clip, faces, SIZE, SIZE)


def test_sweep_count_is_the_functions_need(bench_coverage):
    fragments, covered = bench_coverage
    assert 0 < covered <= fragments <= 3 * covered
    nbytes, ops = work.sweep_work(fragments, covered, BATCH, FACES, SIZE,
                                  SIZE, 3)
    # The state K1 writes, chip_smoke's state_bytes: (C + 9) floats a pixel.
    state = BATCH * SIZE * SIZE * (3 + 9) * 4
    assert nbytes == state + BATCH * FACES * work.SWEEP_FACE_FLOATS * 4
    assert state < nbytes <= CHIP_SMOKE_K1[0]
    assert ops <= CHIP_SMOKE_K1[1]
    assert work.bound(nbytes, ops)[1] == "bytes"


def test_reduce_count_is_the_functions_need(bench_coverage):
    fragments, covered = bench_coverage
    nbytes, ops = work.reduce_work(fragments, covered, BATCH, FACES, SIZE,
                                   SIZE, 3)
    assert ops == covered * (31 + 6 * 3) <= CHIP_SMOKE_K3[1]
    # 15 planes a covered pixel (12 + C, chip_smoke's n_planes), rows of
    # 9 + 3C floats (its d_out); the covered pixels' planes are within
    # the planes of the tiles K3's runs visit.
    assert nbytes == 4 * (covered * 15 + BATCH * FACES * (12 + 9 + 9))
    assert nbytes <= CHIP_SMOKE_K3[0]


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert work.bound(3.35e9, 0) == (1.0, "bytes")
    assert work.bound(0, 67e9 * 2) == (2.0, "operations")
