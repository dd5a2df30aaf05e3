"""The cell's inputs are the tensors they were before meshes and entry
points became modules of their own: the same draws, in the same order,
from the same generator.  GOLDEN below is the harness's `make_inputs`
and `make_cylinder` as they stood then, kept frozen; the readings of
every cell rest on these tensors."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100.harness import inputs

from .conftest import cell_from_files, tiny

LIGHT = (0.3, -0.5, -0.8)
GBUFFER_CHANNELS = 10


def golden_cylinder(radius, height, end_offset, bevel, segments):
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


def golden_inputs(config, traffic, seed, device):
    mesh = config["mesh"]
    vertices, faces = golden_cylinder(mesh["radius"], mesh["height"],
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
    out = dict(
        homogeneous=homogeneous,
        faces=torch.as_tensor(faces, device=device).expand(
            batch, -1, -1).contiguous(),
        pool=uniform(traffic["pool"], batch, 3) * 2 - 1)
    if traffic["entry"] == "deferred":
        normals = torch.randn(batch, num_vertices, 3, generator=generator,
                              device=device)
        out.update(
            albedo=0.2 + 0.8 * uniform(batch, num_vertices, 3),
            normals=normals / torch.linalg.norm(normals, dim=-1,
                                                keepdim=True),
            background=torch.zeros(batch, height, width, GBUFFER_CHANNELS,
                                   device=device),
            light=torch.tensor(LIGHT, device=device))
    else:
        out.update(colors=uniform(batch, num_vertices, channels),
                   background=uniform(batch, height, width, channels))
    out["weights"] = uniform(batch, height, width, 3)
    return SimpleNamespace(**out)


MIXES = {
    "deferred": lambda: tiny("cyl65536_b4_512.deferred", segments=16),
    "distant": lambda: tiny("cyl65536_b32_512.distant", segments=16),
    "orbit": lambda: tiny(cell_from_files(
        "cyl512_b16_256", "orbit", "cyl512_b16_256.orbit"), segments=16),
}
COMMON = ("homogeneous", "faces", "pool", "background", "weights")


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 13])
def test_inputs_are_the_golden_tensors(mix, seed):
    cell = MIXES[mix]()
    got = inputs.make_inputs(cell, seed, "cpu")
    want = golden_inputs(cell.config, cell.traffic, seed, "cpu")
    leaves = set(vars(want)) - set(COMMON)
    assert set(got.tensors) == leaves and got.mesh == {}
    for name in COMMON:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    for name in leaves:
        assert torch.equal(got.tensors[name], getattr(want, name)), name
