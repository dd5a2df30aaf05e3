"""Procedural test/sample geometry (numpy; a copy of dirt_tpu/utils/meshes.py
so the port never imports the JAX package).

These generators replace the ad-hoc geometry builders scattered through the
reference's samples and tests (samples/simple.py:15-23 `build_cube`,
tests/rasterise_tests.py:11-47 `make_cylinder`).
"""

import numpy as np


def build_cube():
    """Unit cube centred at the origin; returns (vertices [8,3], faces [12,3])."""
    vertices = np.array(
        [[x, y, z] for z in (-1., 1.) for y in (-1., 1.) for x in (-1., 1.)],
        np.float32)
    quads = [
        [0, 1, 3, 2], [4, 5, 7, 6],  # back, front
        [1, 5, 4, 0], [2, 6, 7, 3],  # bottom, top
        [4, 6, 2, 0], [3, 7, 5, 1],  # left, right
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append([a, b, c])
        faces.append([c, d, a])
    return vertices, np.array(faces, np.int32)


def make_cylinder(radius, height, end_offset, bevel, segments):
    """Cylinder on the y-axis with bevelled conical ends.

    Mirrors the procedural mesh the reference's gradient-correctness harness
    renders (tests/rasterise_tests.py:11-47): four rings of vertices (two
    bevel rings, two rim rings) plus two apex points, triangulated into three
    quad rings and two end fans.

    Returns:
        (vertices [4*segments + 2, 3] float32, faces [.., 3] int32)
    """
    angles = np.linspace(0., 2 * np.pi, segments, endpoint=False,
                         dtype=np.float32)
    ring = np.stack([np.cos(angles), np.sin(angles)], axis=1) * radius

    def ring_at(y, shrink):
        return np.stack([
            ring[:, 0] * (1. - shrink),
            np.full(segments, y, np.float32),
            ring[:, 1] * (1. - shrink),
        ], axis=1)

    top_bevel = ring_at(-height / 2. - radius * bevel, bevel)
    top = ring_at(-height / 2., 0.)
    bottom = ring_at(height / 2., 0.)
    bottom_bevel = ring_at(height / 2. + radius * bevel, bevel)
    ends = np.array([[0., -height / 2. - end_offset, 0.],
                     [0., height / 2. + end_offset, 0.]], np.float32)
    vertices = np.concatenate(
        [top_bevel, top, bottom, bottom_bevel, ends], axis=0)

    faces = []
    for start in (0, segments, 2 * segments):
        for q in range(segments):
            a = start + q
            b = start + (q + 1) % segments
            c = a + segments
            d = b + segments
            faces.append([a, b, c])
            faces.append([c, b, d])
    for q in range(segments):
        a, b = q, (q + 1) % segments
        faces.append([4 * segments, a, b])
        faces.append([4 * segments + 1,
                      3 * segments + a, 3 * segments + b])
    return vertices, np.array(faces, np.int32)


def two_squares(front_depth=0.0, back_depth=0.5, front_offset=0.0,
                size=0.5, back_size=0.7):
    """Two overlapping axis-aligned squares at different depths.

    A minimal occlusion scene for testing that boundary gradients flow to the
    occluder (the behaviour established by rasterise_grad_egl.cu:153-194).

    Returns (vertices [8, 4], faces [4, 3], front_ids, back_ids).
    """
    def square(cx, cy, half, z):
        return np.array([
            [cx - half, cy - half, z, 1.],
            [cx - half, cy + half, z, 1.],
            [cx + half, cy + half, z, 1.],
            [cx + half, cy - half, z, 1.],
        ], np.float32)

    front = square(front_offset, 0., size / 2., front_depth)
    back = square(0., 0., back_size / 2., back_depth)
    vertices = np.concatenate([front, back], axis=0)
    faces = np.array([
        [0, 1, 2], [0, 2, 3],      # front square
        [4, 5, 6], [4, 6, 7],      # back square
    ], np.int32)
    return vertices, faces, np.arange(4), np.arange(4, 8)
