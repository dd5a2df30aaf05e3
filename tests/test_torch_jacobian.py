"""Brute-force Jacobian checks of the port on the bevelled-cylinder scene.

Ports tests/test_cylinder_jacobian.py's four checks (48 x 36, the cylinder
split by face and Lambert-shaded): background-colour rows against central
differences within 1e-4; translation rows against one-pixel central
differences within rtol 0.35 (x, y) and by sign (z); 30 steps of rotation
descent ending under 0.4 x the initial error; pre-split normals render
like generic ones.  The scene, render and checks are chip_smoke.py's
(phase 4l runs them on the card), here with device "cpu".  The port's
translation gradient is also held within 1e-3 (normalised) of dirt_tpu's
on the same scene: the occluder dilation's exact compares flip with an
ulp of the scene math (ROADMAP.md, queue 3), and the x row itself sits at
0.34994 of its 0.35 tolerance in both packages.
"""

import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu_torch
from dirt_tpu_torch import lighting, matrices
from dirt_tpu_torch.utils import meshes

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
import chip_smoke  # noqa: E402
import test_cylinder_jacobian as jtest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


W, H = chip_smoke.JACOBIAN_SIZE


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.jacobian_scene()


def test_scene_matches_dirt_tpu(scene):
    want = jtest._scene()
    np.testing.assert_array_equal(scene[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(scene[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(scene[2].numpy(), np.asarray(want[2]),
                               atol=1e-6)
    assert (W, H) == (jtest.W, jtest.H)


def test_jacobian_rows_background_color_exact(scene):
    rows = chip_smoke.jacobian_background_rows(scene, "cpu")
    assert len(rows) == 4
    for g, fd in rows:
        np.testing.assert_allclose(g, fd, atol=1e-4)


def test_jacobian_rows_translation_approximate(scene):
    g, fd = chip_smoke.jacobian_translation(scene, "cpu")
    for axis in (0, 1):
        assert abs(fd[axis]) > 1e-2
        np.testing.assert_allclose(g[axis], fd[axis], rtol=0.35)
    assert np.sign(g[2]) == np.sign(fd[2]) and abs(g[2]) > 1e-3


def test_translation_gradient_matches_dirt_tpu(scene):
    g, _ = chip_smoke.jacobian_translation(scene, "cpu")
    vertices, faces, colors = jtest._scene()
    ramp = (jnp.linspace(0., 1., W)[None, :, None]
            + jnp.linspace(0., 2., H)[:, None, None])
    want = np.asarray(jax.grad(lambda t: jnp.sum(jtest._render(
        vertices, faces, colors, t, jnp.asarray(0.),
        jnp.asarray(chip_smoke.JACOBIAN_BG)) * ramp))(
            jnp.asarray([0., 0., -0.25])))
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(g / scale, want / scale, atol=1e-3, rtol=0)


def test_rotation_gradient_descends_to_target(scene):
    initial, final = chip_smoke.rotation_descent(scene, "cpu")
    assert final < 0.4 * initial, (final, initial)


def test_pre_split_normals_render_identically():
    vertices, faces = meshes.make_cylinder(0.3, 0.8, 0.1, 0.2, 12)
    vertices = np.concatenate(
        [vertices, np.ones([len(vertices), 1], np.float32)], axis=1)
    split_v, split_f = lighting.split_vertices_by_face(vertices, faces,
                                                       device="cpu")
    n_generic = lighting.vertex_normals(split_v[..., :3], split_f)
    n_fast = lighting.vertex_normals_pre_split(split_v[..., :3], split_f)

    def shade_and_render(normals):
        colors = lighting.diffuse_directional(
            normals, torch.ones_like(normals),
            light_direction=torch.tensor([0.5, -0.5, -0.7]),
            light_color=torch.tensor([1., 1., 1.]))
        view = matrices.translation(torch.tensor([0., 0., -2.5]))
        proj = matrices.perspective_projection(0.1, 20., 0.2, float(H) / W,
                                               device="cpu")
        return dirt_tpu_torch.rasterise(
            torch.zeros(H, W, 3), split_v @ view @ proj, colors, split_f)

    generic = shade_and_render(n_generic)
    np.testing.assert_allclose(generic.numpy(),
                               shade_and_render(n_fast).numpy(), atol=1e-5)
    assert float(generic.max()) > 0
