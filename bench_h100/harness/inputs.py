"""The cell's inputs, made on the device from the seed.

Both sides, the program and the reference, get these same tensors: the
object-space mesh (fixed by the configuration), a pool of rotation
batches (step k takes entry k mod pool), and the colours, background
and loss weights (or, for the deferred mix, albedo, normals, light and a
zero G-buffer background).
"""

import random
from dataclasses import dataclass

import numpy as np
import torch

LIGHT = (0.3, -0.5, -0.8)
GBUFFER_CHANNELS = 10   # mask, clip xyz, albedo, unit normals


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


@dataclass
class Inputs:
    deferred: bool
    homogeneous: torch.Tensor    # [V, 4] object space
    faces: torch.Tensor          # [B, F, 3] int32
    pool: torch.Tensor           # [P, B, 3] rotation vectors
    background: torch.Tensor     # [B, H, W, C] (deferred: zeros, 10)
    weights: torch.Tensor        # [B, H, W, 3] loss weights
    colors: torch.Tensor = None  # [B, V, 3] direct
    albedo: torch.Tensor = None  # [B, V, 3] deferred
    normals: torch.Tensor = None  # [B, V, 3] deferred, unit
    light: torch.Tensor = None   # [3] deferred


def make_inputs(config, traffic, seed, device):
    """The cell's inputs from `seed`, drawn on `device` in a few calls."""
    mesh = config["mesh"]
    vertices, faces = make_cylinder(mesh["radius"], mesh["height"],
                                    mesh["end_offset"], mesh["bevel"],
                                    mesh["segments"])
    batch, height, width = config["batch"], config["height"], config["width"]
    channels = config["channels"]
    num_vertices = vertices.shape[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    uniform = lambda *shape: torch.rand(shape, generator=generator,
                                        device=device)
    homogeneous = torch.cat([torch.as_tensor(vertices, device=device),
                             torch.ones(num_vertices, 1, device=device)], 1)
    inputs = dict(
        homogeneous=homogeneous,
        faces=torch.as_tensor(faces, device=device).expand(
            batch, -1, -1).contiguous(),
        pool=uniform(traffic["pool"], batch, 3) * 2 - 1)
    if traffic["entry"] == "deferred":
        normals = torch.randn(batch, num_vertices, 3, generator=generator,
                              device=device)
        inputs.update(
            albedo=0.2 + 0.8 * uniform(batch, num_vertices, 3),
            normals=normals / torch.linalg.norm(normals, dim=-1,
                                                keepdim=True),
            background=torch.zeros(batch, height, width, GBUFFER_CHANNELS,
                                   device=device),
            light=torch.tensor(LIGHT, device=device))
    else:
        inputs.update(colors=uniform(batch, num_vertices, channels),
                      background=uniform(batch, height, width, channels))
    inputs["weights"] = uniform(batch, height, width, 3)
    return Inputs(deferred=traffic["entry"] == "deferred", **inputs)


def kept_samples(seed, traffic, batch):
    """The pool entries whose latest outputs the window keeps for the
    check, each with the image of the batch whose pixels it keeps: drawn
    from `seed`."""
    rng = random.Random(seed)
    entries = rng.sample(range(traffic["pool"]), traffic["kept_entries"])
    return {entry: rng.randrange(batch) for entry in entries}
