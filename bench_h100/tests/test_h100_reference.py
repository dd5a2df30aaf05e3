"""The frozen reference against the port's CPU path at small sizes: the
windowed brute force == the port's whole-image brute force, the plain
gradient == the port's plain gradient, and both entry points under
autograd == the port's blocks backend (its kernels' plain versions)."""

import numpy as np
import pytest
import torch

import dirt_tpu_torch
from dirt_tpu_torch.ops import backward as port_backward
from dirt_tpu_torch.ops import reference as port_reference

from bench_h100.harness import inputs
from bench_h100.meshes.cylinder import make_cylinder
from bench_h100.reference import autograd, forward, gradient, scene

from .conftest import cell_from_files


def soup(seed, batch=2, size=40, num_faces=80, crossing=False):
    """Random triangles; with `crossing`, some corners at w <= 0."""
    rng = np.random.RandomState(seed)
    nv = 60
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 1.0)
    f = rng.randint(0, nv, size=(batch, num_faces, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    return tuple(map(torch.as_tensor, (bg, v, c, f)))


def cylinder(batch=3, size=48, segments=24, right=0.25, seed=0):
    vertices, faces = make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    homogeneous = torch.cat([torch.as_tensor(vertices),
                             torch.ones(len(vertices), 1)], 1)
    generator = torch.Generator().manual_seed(seed)
    rotations = torch.rand(batch, 3, generator=generator) * 2 - 1
    view, projection = scene.camera(right, 3.0, "cpu")
    clip = scene.clip_vertices(homogeneous, rotations, view, projection)
    colors = torch.rand(batch, len(vertices), 3, generator=generator)
    bg = torch.rand(batch, size, size, 3, generator=generator)
    return bg, clip, colors, torch.as_tensor(faces).expand(
        batch, -1, -1).contiguous()


@pytest.mark.parametrize("case", ["soup", "crossing", "cylinder", "zoom"])
def test_windowed_forward_equals_the_whole_image_sweep(case):
    bg, v, c, f = {"soup": lambda: soup(1),
                   "crossing": lambda: soup(2, crossing=True),
                   "cylinder": lambda: cylinder(),
                   "zoom": lambda: cylinder(right=0.05)}[case]()
    px, aux = forward.rasterise_batch(bg, v, c, f)
    want_px, want = port_reference.rasterise_batch(bg, v, c, f)
    assert torch.equal(aux.face_index, want.face_index)
    assert (aux.face_index >= 0).any()
    assert torch.equal(px, want_px)
    for name in ("indices", "barycentric", "clip_w"):
        assert torch.equal(getattr(aux, name), getattr(want, name)), name


def test_plain_gradient_equals_the_ports():
    bg, v, c, f = cylinder()
    px, aux = forward.rasterise_batch(bg, v, c, f)
    g = torch.rand(px.shape, generator=torch.Generator().manual_seed(3))
    got = gradient.grad_grouped(v, px, g, aux)
    want = port_backward.rasterise_grad_grouped(
        v, f, px, g, port_reference.RasterAux(*aux), implementation="xla")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _grads(entry, leaves, weights):
    pixels = entry(*leaves)
    (pixels * weights).sum().backward()
    return pixels.detach(), [x.grad for x in leaves]


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def test_direct_entry_against_the_ports_blocks_path(blocks_on_cpu):
    bg, clip, colors, faces = cylinder()
    weights = torch.rand(bg.shape, generator=torch.Generator().manual_seed(5))
    want = _grads(lambda b, v, c: autograd.rasterise_batch(b, v, c, faces),
                  _leaves(bg, clip, colors), weights)
    got = _grads(lambda b, v, c: dirt_tpu_torch.rasterise_batch(b, v, c,
                                                                faces),
                 _leaves(bg, clip, colors), weights)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_deferred_entry_against_the_ports_blocks_path(blocks_on_cpu):
    cell = cell_from_files("cyl512_b16_256", "deferred",
                           "cyl512_b16_256.deferred")
    cell.config.update(batch=2, height=40, width=40)
    cell.config["mesh"]["segments"] = 16
    data = inputs.make_inputs(cell, 11, "cpu")
    view, projection = scene.camera(0.25, 3.0, "cpu")
    clip = scene.clip_vertices(data.homogeneous, data.pool[0], view,
                               projection)
    light = data.tensors["light"]

    def entry(port):
        def run(bg, v, albedo, normals, lit):
            attributes = scene.gbuffer_attributes(v, albedo, normals)
            shade = lambda gbuffer: scene.shader(gbuffer, lit)
            if port:
                return dirt_tpu_torch.rasterise_batch_deferred(
                    bg, v, attributes, data.faces, shade)
            return autograd.rasterise_batch_deferred(bg, v, attributes,
                                                     data.faces, shade)
        return run

    tensors = (data.background, clip, data.tensors["albedo"],
               data.tensors["normals"], light)
    want = _grads(entry(False), _leaves(*tensors), data.weights)
    got = _grads(entry(True), _leaves(*tensors), data.weights)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-12)
