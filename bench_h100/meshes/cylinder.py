"""DIRT's test cylinder (pmh47/dirt tests/rasterise_tests.py), the mesh of
every configuration whose `mesh.kind` is "cylinder"."""

import numpy as np


def make_cylinder(radius, height, end_offset, bevel, segments):
    """A cylinder on the y-axis with bevelled conical ends (DIRT's
    tests/rasterise_tests.py mesh): four rings and two apex points,
    three quad rings and two end fans, 8 * segments faces.  Returns
    (vertices [4 * segments + 2, 3] float32, faces [F, 3] int32)."""
    angles = np.linspace(0., 2 * np.pi, segments, endpoint=False,
                         dtype=np.float32)
    ring = np.stack([np.cos(angles), np.sin(angles)], axis=1) * radius

    def ring_at(y, shrink):
        return np.stack([ring[:, 0] * (1. - shrink),
                         np.full(segments, y, np.float32),
                         ring[:, 1] * (1. - shrink)], axis=1)

    vertices = np.concatenate([
        ring_at(-height / 2. - radius * bevel, bevel),
        ring_at(-height / 2., 0.), ring_at(height / 2., 0.),
        ring_at(height / 2. + radius * bevel, bevel),
        np.array([[0., -height / 2. - end_offset, 0.],
                  [0., height / 2. + end_offset, 0.]], np.float32)], axis=0)
    faces = []
    for start in (0, segments, 2 * segments):
        for q in range(segments):
            a, b = start + q, start + (q + 1) % segments
            faces += [[a, b, a + segments], [a + segments, b, b + segments]]
    for q in range(segments):
        a, b = q, (q + 1) % segments
        faces += [[4 * segments, a, b],
                  [4 * segments + 1, 3 * segments + a, 3 * segments + b]]
    return vertices.astype(np.float32), np.array(faces, np.int32)


def make(mesh):
    """The cylinder of `mesh`'s radius, height, end_offset, bevel and
    segments; no per-vertex arrays beside the positions."""
    vertices, faces = make_cylinder(mesh["radius"], mesh["height"],
                                    mesh["end_offset"], mesh["bevel"],
                                    mesh["segments"])
    return {"vertices": vertices, "faces": faces}
