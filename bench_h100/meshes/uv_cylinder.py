"""DIRT's test cylinder with a UV atlas, the mesh of every configuration
whose `mesh.kind` is "uv_cylinder".

The triangles are meshes/cylinder.py's (make_cylinder), by position and
in the same order, corners in the same order; only the vertex ids change
where the atlas needs a vertex twice:

  u  the angle over 2 pi, each ring's seam column duplicated at u = 1, so
     that the last quad of a ring runs from u = (S - 1) / S to 1;
  v  the arc length along the profile (apex, the four rings, apex),
     normalised to [0, 1] from apex to apex;
  each end fan's apex is duplicated for every fan face, at the middle u
     of the face's segment.

So no face spans more than one segment's share of u (1 / S).  Vertices:
4 (S + 1) ring vertices (ring r, column j at r (S + 1) + j), then the S
bottom apexes, then the S top apexes.
"""

import numpy as np

from bench_h100.meshes.cylinder import make_cylinder


def make_uv_cylinder(radius, height, end_offset, bevel, segments):
    """(vertices [4 (S + 1) + 2 S, 3] float32, faces [8 S, 3] int32, uvs
    [V, 2] float32) of the cylinder with `segments` = S segments."""
    s = segments
    positions, _ = make_cylinder(radius, height, end_offset, bevel, s)
    columns = np.arange(s + 1)
    rings = np.concatenate([r * s + columns % s for r in range(4)])
    vertices = np.concatenate([positions[rings],
                               np.repeat(positions[4 * s:4 * s + 1], s, 0),
                               np.repeat(positions[4 * s + 1:], s, 0)])
    # The profile (distance from the axis, height): apex, rings 0-3, apex.
    profile = np.array(
        [[0., -height / 2. - end_offset],
         [radius * (1. - bevel), -height / 2. - radius * bevel],
         [radius, -height / 2.], [radius, height / 2.],
         [radius * (1. - bevel), height / 2. + radius * bevel],
         [0., height / 2. + end_offset]], np.float64)
    arc = np.concatenate([[0.], np.cumsum(np.linalg.norm(
        np.diff(profile, axis=0), axis=1))])
    v = arc / arc[-1]
    u_ring = columns / s
    u_apex = (np.arange(s) + 0.5) / s
    uvs = np.concatenate(
        [np.stack([u_ring, np.full(s + 1, v[1 + r])], 1) for r in range(4)]
        + [np.stack([u_apex, np.full(s, v[0])], 1),
           np.stack([u_apex, np.full(s, v[5])], 1)])
    ring = lambda r, j: r * (s + 1) + j
    bottom, top = 4 * (s + 1), 4 * (s + 1) + s
    faces = []
    for r in range(3):
        for q in range(s):
            a, b = ring(r, q), ring(r, q + 1)
            c, d = ring(r + 1, q), ring(r + 1, q + 1)
            faces += [[a, b, c], [c, b, d]]
    for q in range(s):
        faces += [[bottom + q, ring(0, q), ring(0, q + 1)],
                  [top + q, ring(3, q), ring(3, q + 1)]]
    return (vertices.astype(np.float32), np.array(faces, np.int32),
            uvs.astype(np.float32))


def make(mesh):
    """The UV cylinder of `mesh`'s radius, height, end_offset, bevel and
    segments, with per-vertex `uvs` [V, 2] (u, v)."""
    vertices, faces, uvs = make_uv_cylinder(
        mesh["radius"], mesh["height"], mesh["end_offset"], mesh["bevel"],
        mesh["segments"])
    return {"vertices": vertices, "faces": faces, "uvs": uvs}
