"""The whole differentiable step, dirt_tpu_torch against dirt_tpu on the CPU.

A small bench-like scene (2 x 64 x 64, the Gouraud cylinder at
segments=8, loss sum(pixels * weights)) goes through jax.grad of
dirt_tpu.rasterise_batch and through torch.autograd of
dirt_tpu_torch.rasterise_batch, from the same numpy inputs.  Tolerances:
pixels atol=1e-4, rtol=1e-5 (bench.py's oracle tolerance); grad_background
exactly (a pass-through of the cotangent outside coverage); vertex and
colour gradients within max |a - b| / max(max |a|, 1) <= 3e-6
(tests/test_grad_kernels.py's bound between dirt_tpu's own gradient
backends, which sum in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from dirt_tpu_torch import matrices
from dirt_tpu_torch.utils import meshes


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


TOL = 3e-6


def scene(batch=2, resolution=64, segments=8, seed=0):
    """bench.py's scene construction at a small size, in numpy."""
    rng = np.random.RandomState(seed)
    vertices, faces = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    homogeneous = np.concatenate(
        [vertices, np.ones((vertices.shape[0], 1), np.float32)], axis=1)
    view = matrices.compose(
        matrices.translation([0., 0., -3.0], device="cpu"),
        matrices.rodrigues([-0.4, 0., 0.], device="cpu"))
    projection = matrices.perspective_projection(0.1, 20., 0.25, 1.,
                                                 device="cpu")
    rotations = matrices.rodrigues(
        rng.uniform(-1, 1, size=(batch, 3)).astype(np.float32), device="cpu")
    clip = (torch.einsum("vi,bij->bvj", torch.as_tensor(homogeneous),
                         rotations) @ view @ projection).numpy()
    colors = rng.uniform(size=(batch, vertices.shape[0], 3)).astype(
        np.float32)
    background = rng.uniform(size=(batch, resolution, resolution, 3)).astype(
        np.float32)
    weights = rng.uniform(size=(batch, resolution, resolution, 3)).astype(
        np.float32)
    faces_b = np.broadcast_to(faces, (batch,) + faces.shape).copy()
    return background, clip, colors, faces_b, weights


def jax_step(background, clip, colors, faces, weights, backend):
    def loss(c, col, bg):
        px = dirt_tpu.rasterise_batch(bg, c, col, faces, backend=backend)
        return jnp.sum(px * weights), px
    (_, px), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                        has_aux=True)(
        jnp.asarray(clip), jnp.asarray(colors), jnp.asarray(background))
    g_clip, g_colors, g_bg = (np.asarray(g) for g in grads)
    return np.asarray(px), g_bg, g_clip, g_colors


def torch_step(background, clip, colors, faces, weights, backend):
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (background, clip, colors)]
    px = dirt_tpu_torch.rasterise_batch(leaves[0], leaves[1], leaves[2],
                                        torch.as_tensor(faces),
                                        backend=backend)
    (px * torch.as_tensor(weights)).sum().backward()
    return (px.detach().numpy(),) + tuple(x.grad.numpy() for x in leaves)


@pytest.fixture(scope="module")
def bench_scene():
    return scene()


@pytest.mark.parametrize("backend", [None, "blocks"])
def test_step_matches_jax(bench_scene, backend):
    # None: both packages' CPU default (reference forward, scatter
    # gradient).  "blocks": dirt_tpu's blocks forward (interpret mode) with
    # its CPU gradient, against the port's blocks forward AND blocks
    # gradient (the plain versions of all four kernels).
    want = jax_step(*bench_scene, backend)
    got = torch_step(*bench_scene, backend)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    for name, a, b in zip(("clip", "colors"), want[2:], got[2:]):
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b / scale, a / scale, atol=TOL,
                                   err_msg=name)
    assert np.abs(got[2]).max() > 0 and np.abs(got[3]).max() > 0
    # No gradient reaches clip z (the reference never produces one).
    assert np.count_nonzero(got[2][..., 2]) == 0


def test_blocks_and_reference_steps_agree(bench_scene):
    ref = torch_step(*bench_scene, "reference")
    blk = torch_step(*bench_scene, "blocks")
    np.testing.assert_allclose(blk[0], ref[0], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(blk[1], ref[1])
    for a, b in zip(ref[2:], blk[2:]):
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b / scale, a / scale, atol=TOL)


def test_single_image_rasterise_matches_batch(bench_scene):
    background, clip, colors, faces, _ = bench_scene
    one = dirt_tpu_torch.rasterise(background[0], clip[0], colors[0],
                                   faces[0], height=64, width=64, channels=3,
                                   device="cpu")
    batch = dirt_tpu_torch.rasterise_batch(background, clip, colors, faces,
                                           device="cpu")
    assert torch.equal(one, batch[0])
    with pytest.raises(ValueError):
        dirt_tpu_torch.rasterise(background[0], clip[0], colors[0], faces[0],
                                 height=63, device="cpu")


def test_with_aux_is_outside_autograd(bench_scene):
    background, clip, colors, faces, _ = bench_scene
    clip_t = torch.tensor(clip, requires_grad=True)
    pixels, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip_t, colors, faces, backend="blocks")
    assert not pixels.requires_grad
    assert aux.dropped.tolist() == [0, 0]
    assert int(aux.face_index.max()) >= 0


def test_faces_get_no_gradient(bench_scene):
    background, clip, colors, faces, weights = bench_scene
    v = torch.tensor(clip, requires_grad=True)
    px = dirt_tpu_torch.rasterise_batch(background, v, colors, faces)
    grad_px = torch.as_tensor(weights)
    (g_v,) = torch.autograd.grad(px, v, grad_px)
    assert g_v.shape == v.shape and torch.isfinite(g_v).all()
