"""The port's gradient semantics against dirt_tpu's on the same scenes.

Ports tests/test_gradients.py's checks (the two finite-difference checks,
vertex colour and translation, and the pallas backend's gradient among
them) and four of tests/test_dilation.py's (the debug image of :145
included: tests/test_torch_deferred.py holds the debug image equal to
dirt_tpu's on a random scene, not the occluder scene's marks): each
runs the same numpy scene through dirt_tpu (jitted, on the CPU) and
dirt_tpu_torch (device="cpu": the reference forward and the plain scatter
gradient), holds the port against dirt_tpu, then checks the property
dirt_tpu's test checks.  These axis-aligned scenes rasterise bit for bit
alike in both packages, so the forward residuals and the dilation agree
exactly; vertex and colour gradients are held within 3e-6 of
max(max |dirt_tpu's|, 1) (the packages sum their scatters in different
orders), the background gradient exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu_torch.ops import backward, dispatch
from dirt_tpu_torch.utils import meshes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


H, W = 32, 48
TOL = 3e-6
QUAD = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _square(cx, cy, half, z, w):
    return np.array([
        [cx - half, cy - half, z, w],
        [cx - half, cy + half, z, w],
        [cx + half, cy + half, z, w],
        [cx + half, cy - half, z, w],
    ], np.float32) * [w, w, 1, 1]


def _port_grads(loss_of, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss_of(*leaves).backward()
    return [x.grad.numpy() for x in leaves]


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _occluded_scene():
    front = _square(0., 0., 0.4, 0., 1.)
    back = _square(0., 0., 4.0, 0.5, 2.)
    vertices = np.concatenate([front, back])
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    colors = np.array([[1., 0., 0.]] * 4 + [[0., 1., 0.]] * 4, np.float32)
    return vertices, faces, colors


def test_background_gradient_exact():
    vertices = _square(0., 0., 0.4, 0., 1.)
    colors = np.ones((4, 1), np.float32)
    ramp = np.arange(H * W, dtype=np.float32).reshape(H, W, 1)
    background = np.zeros((H, W, 1), np.float32)
    got, = _port_grads(lambda bg: torch.sum(dirt_tpu_torch.rasterise(
        bg, torch.tensor(vertices), torch.tensor(colors),
        torch.tensor(QUAD)) * torch.tensor(ramp)), background)
    want = np.asarray(jax.jit(jax.grad(lambda bg: jnp.sum(dirt_tpu.rasterise(
        bg, vertices, colors, QUAD) * ramp)))(background))
    np.testing.assert_array_equal(got, want)
    pixels = dirt_tpu_torch.rasterise(background, vertices, colors, QUAD,
                                      device="cpu").numpy()
    expected = np.where(pixels[..., 0] > 0, 0., ramp[..., 0])
    np.testing.assert_array_equal(got[..., 0], expected)


def test_occlusion_boundary_gradient_goes_to_occluder():
    vertices, faces, colors = _occluded_scene()
    weights = np.random.RandomState(3).randn(H, W, 3).astype(np.float32)
    background = np.zeros((H, W, 3), np.float32)
    got, = _port_grads(lambda v: torch.sum(dirt_tpu_torch.rasterise(
        torch.tensor(background), v, torch.tensor(colors),
        torch.tensor(faces)) * torch.tensor(weights)), vertices)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(dirt_tpu.rasterise(
        background, v, colors, faces) * weights)))(vertices))
    _close(got, want)
    front_norm = np.abs(got[:4]).sum()
    back_norm = np.abs(got[4:]).sum()
    assert front_norm > 1.0
    assert back_norm < 0.05 * front_norm, (front_norm, back_norm)


def test_batch_gradients_match_stacked_singles():
    rng = np.random.RandomState(5)
    vertices = np.stack([_square(-0.2, 0., 0.4, 0., 1.),
                         _square(0.3, 0.1, 0.3, 0., 1.)])
    colors = rng.uniform(size=(2, 4, 3)).astype(np.float32)
    weights = rng.randn(2, H, W, 3).astype(np.float32)
    faces = np.stack([QUAD, QUAD])
    background = np.zeros((2, H, W, 3), np.float32)
    got, = _port_grads(lambda v: torch.sum(dirt_tpu_torch.rasterise_batch(
        torch.tensor(background), v, torch.tensor(colors),
        torch.tensor(faces)) * torch.tensor(weights)), vertices)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
        dirt_tpu.rasterise_batch(background, v, colors, faces)
        * weights)))(vertices))
    _close(got, want)
    for i in range(2):
        single, = _port_grads(lambda v: torch.sum(dirt_tpu_torch.rasterise(
            torch.tensor(background[i]), v, torch.tensor(colors[i]),
            torch.tensor(QUAD)) * torch.tensor(weights[i])), vertices[i])
        np.testing.assert_array_equal(got[i], single)


def test_no_gradient_to_clip_z():
    vertices = _square(0., 0., 0.4, 0.3, 1.)
    background = np.zeros((H, W, 1), np.float32)
    ones = np.ones((4, 1), np.float32)
    got, = _port_grads(lambda v: torch.sum(dirt_tpu_torch.rasterise(
        torch.tensor(background), v, torch.tensor(ones),
        torch.tensor(QUAD)) ** 2), vertices)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(dirt_tpu.rasterise(
        background, v, ones, QUAD) ** 2)))(vertices))
    _close(got, want)
    np.testing.assert_array_equal(got[:, 2], np.zeros(4))
    assert np.abs(got).sum() > 0


def _aux_both(vertices, faces, colors, size=32):
    """dirt_tpu's reference forward of one image, for both packages:
    (pixels, aux as torch tensors, and as dirt_tpu's arrays).  The
    dilation is compared on the same residuals: at the backdrop's shared
    diagonal XLA's CPU code may give a pixel to the other triangle of the
    same square (it contracts FMAs; the port follows the native oracle),
    which moves no pixel value, only the vertex triple there."""
    background = np.zeros((1, size, size, colors.shape[-1]), np.float32)
    args = (background, vertices[None], colors[None], faces[None])
    jpixels, jaux = jdispatch.forward_batch(*map(jnp.asarray, args))
    pixels, _ = dispatch.forward_batch(*map(torch.tensor, args))
    np.testing.assert_array_equal(pixels.numpy(), np.asarray(jpixels))
    aux = type(_)(*(torch.tensor(np.asarray(getattr(jaux, name)))
                    for name in _._fields[:4]))
    return torch.tensor(np.asarray(jpixels)), aux, jpixels, jaux


def _dilate_both(pixels, aux, jpixels, jaux):
    """(port's, dirt_tpu's) (indices, barycentric, clip_w, dilated) after
    the occluder dilation of image 0, held equal."""
    scharr = backward.scharr_filters(pixels)
    idx, bary, w, dilated, _ = backward._dilate(
        aux.indices, aux.barycentric, aux.clip_w, *scharr, aux.face_index)
    port = [t[0].numpy() for t in (idx, bary, w, dilated)]
    jscharr = jbackward.scharr_filters(jpixels[0])
    theirs = [np.asarray(t) for t in jbackward._dilate(
        jaux.indices[0], jaux.barycentric[0], jaux.clip_w[0], *jscharr)]
    for got, want in zip(port, theirs):
        np.testing.assert_array_equal(got, want)
    return port


def test_dilation_adopts_occluder_at_boundary():
    front = np.array([[-0.4, -0.4, 0., 1.], [-0.4, 0.4, 0., 1.],
                      [0.4, 0.4, 0., 1.], [0.4, -0.4, 0., 1.]], np.float32)
    back = np.array([[-4., -4., 1., 2.], [-4., 4., 1., 2.],
                     [4., 4., 1., 2.], [4., -4., 1., 2.]], np.float32)
    vertices = np.concatenate([front, back])
    _, faces, colors = _occluded_scene()
    pixels, aux, jpixels, jaux = _aux_both(vertices, faces, colors)
    idx_d, _, w_d, dilated = _dilate_both(pixels, aux, jpixels, jaux)
    indices = aux.indices[0].numpy()
    mid = indices.shape[0] // 2
    left_edge = np.where(indices[mid, :, 0] < 4)[0].min()
    assert indices[mid, left_edge - 1, 0] >= 4
    assert dilated[mid, left_edge - 1]
    assert idx_d[mid, left_edge - 1, 0] < 4
    assert w_d[mid, left_edge - 1] == 1.0
    assert not dilated[mid, left_edge + 3:left_edge + 6].any()


def test_dilation_never_fires_without_depth_difference():
    verts, faces, front, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.0, size=0.6, back_size=0.6)
    colors = np.zeros((8, 3), np.float32)
    colors[front] = 1.
    pixels, aux, jpixels, jaux = _aux_both(verts, faces, colors)
    *_, dilated = _dilate_both(pixels, aux, jpixels, jaux)
    covered = aux.indices[0, ..., 0].numpy() >= 0
    assert not (dilated & covered).any()
    assert (dilated & ~covered).any()


def test_channel_grouping_matches_manual_composition():
    rng = np.random.RandomState(0)
    verts, faces, _, _ = meshes.two_squares()
    colors = rng.uniform(size=(1, 8, 5)).astype(np.float32)
    background = rng.uniform(size=(1, 32, 32, 5)).astype(np.float32)
    grad_pixels = rng.randn(1, 32, 32, 5).astype(np.float32)
    args = (background, verts[None], colors, faces[None])
    pixels, aux = dispatch.forward_batch(*map(torch.tensor, args))
    vertices, faces_b = torch.tensor(verts[None]), torch.tensor(faces[None])
    gb, gv, gc = (t.numpy() for t in backward.rasterise_grad_grouped(
        vertices, faces_b, pixels, torch.tensor(grad_pixels), aux))

    manual_gv, manual_gb, manual_gc = None, [], []
    for begin, end in [(0, 3), (3, 4), (4, 5)]:
        grads = backward.rasterise_grad_batch(
            vertices, faces_b, pixels[..., begin:end],
            torch.tensor(grad_pixels[..., begin:end]), aux)
        manual_gb.append(grads.grad_background.numpy())
        manual_gc.append(grads.grad_vertex_colors.numpy())
        manual_gv = (grads.grad_vertices.numpy() if manual_gv is None
                     else manual_gv + grads.grad_vertices.numpy())
    np.testing.assert_array_equal(gv, manual_gv)
    np.testing.assert_array_equal(gb, np.concatenate(manual_gb, axis=-1))
    np.testing.assert_array_equal(gc, np.concatenate(manual_gc, axis=-1))

    jpixels, jaux = jdispatch.forward_batch(*map(jnp.asarray, args))
    want = [np.asarray(t) for t in jax.jit(jbackward.rasterise_grad_grouped)(
        jnp.asarray(verts[None]), jnp.asarray(faces[None]), jpixels,
        jnp.asarray(grad_pixels), jaux)]
    np.testing.assert_array_equal(gb, want[0])
    _close(gv, want[1])
    _close(gc, want[2])


def _render_translated(t, vertices, faces, colors, channels=3):
    """tests/test_gradients.py's render of `vertices` shifted by t [2]
    (in NDC: x and y move by t * w), on a zero background."""
    shifted = vertices + torch.cat(
        [t * vertices[..., 3:], torch.zeros(vertices.shape[0], 2)], dim=-1)
    return dirt_tpu_torch.rasterise(torch.zeros(H, W, channels), shifted,
                                    colors, faces)


def _render_translated_jax(t, vertices, faces, colors, channels=3):
    shifted = vertices + jnp.concatenate(
        [t * vertices[..., 3:], jnp.zeros((vertices.shape[0], 2))], axis=-1)
    return dirt_tpu.rasterise(jnp.zeros((H, W, channels)), shifted, colors,
                              faces)


def test_vertex_color_gradient_matches_finite_difference():
    rng = np.random.RandomState(0)
    vertices = torch.tensor(_square(-0.1, 0.2, 0.5, 0.1, 1.3))
    colors0 = rng.uniform(size=(4, 3)).astype(np.float32)
    weights = rng.randn(H, W, 3).astype(np.float32)

    def loss(colors):
        return torch.sum(dirt_tpu_torch.rasterise(
            torch.zeros(H, W, 3), vertices, colors, torch.tensor(QUAD))
            * torch.tensor(weights))

    got, = _port_grads(loss, colors0)
    want = np.asarray(jax.jit(jax.grad(lambda c: jnp.sum(dirt_tpu.rasterise(
        jnp.zeros((H, W, 3)), vertices.numpy(), c, QUAD) * weights)))(
            colors0))
    _close(got, want)
    eps = 1e-2
    for v, c in [(0, 0), (1, 2), (3, 1)]:
        delta = np.zeros((4, 3), np.float32)
        delta[v, c] = eps
        with torch.no_grad():
            fd = (loss(torch.tensor(colors0 + delta))
                  - loss(torch.tensor(colors0 - delta))) / (2 * eps)
        np.testing.assert_allclose(got[v, c], float(fd), rtol=2e-3,
                                   atol=1e-3)


def test_translation_gradient_matches_finite_difference():
    vertices = _square(-0.1, 0.1, 0.45, 0., 1.)
    colors = np.ones((4, 3), np.float32) * np.float32([0.9, 0.5, 0.2])
    # Weights vary along both axes, or a pure y-shift's difference is 0.
    weights = ((np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
                + 2.0 * np.linspace(0, 1, H, dtype=np.float32)[:, None, None])
               * np.ones((1, 1, 3), np.float32))

    def loss(t):
        return torch.sum(_render_translated(
            t, torch.tensor(vertices), torch.tensor(QUAD),
            torch.tensor(colors)) * torch.tensor(weights))

    got, = _port_grads(loss, np.zeros(2, np.float32))
    want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        _render_translated_jax(t, vertices, QUAD, colors) * weights)))(
            np.zeros(2, np.float32)))
    _close(got, want)
    for axis, step in enumerate([2.0 / W, 2.0 / H]):   # one pixel an axis
        e = torch.zeros(2)
        e[axis] = step / 2
        with torch.no_grad():
            fd = float(loss(e) - loss(-e)) / step
        assert np.isfinite(fd) and abs(fd) > 1e-3
        # Filter-based gradients: within ~30% of a one-pixel difference.
        np.testing.assert_allclose(got[axis], fd, rtol=0.3)


def test_gradients_work_through_pallas_backend():
    vertices = _square(0., 0., 0.4, 0., 1.)
    weights = np.random.RandomState(9).randn(H, W, 1).astype(np.float32)
    ones = np.ones((4, 1), np.float32)

    def loss(backend):
        return lambda v: torch.sum(dirt_tpu_torch.rasterise(
            torch.zeros(H, W, 1), v, torch.tensor(ones), torch.tensor(QUAD),
            backend=backend) * torch.tensor(weights))

    got, = _port_grads(loss("pallas"), vertices)
    ref, = _port_grads(loss("reference"), vertices)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(dirt_tpu.rasterise(
        jnp.zeros((H, W, 1)), v, ones, QUAD, backend="reference")
        * weights)))(vertices))
    _close(got, want)
    assert np.abs(got).sum() > 0


def test_rasterise_grad_debug_marks_dilated_pixels():
    # The debug surface (the reference grad op's debug_thingy image) on
    # the occluder scene of tests/test_dilation.py:145.
    front = np.array([[-0.4, -0.4, 0., 1.], [-0.4, 0.4, 0., 1.],
                      [0.4, 0.4, 0., 1.], [0.4, -0.4, 0., 1.]], np.float32)
    back = np.array([[-4., -4., 1., 2.], [-4., 4., 1., 2.],
                     [4., 4., 1., 2.], [4., -4., 1., 2.]], np.float32)
    vertices = np.concatenate([front, back])
    _, faces, colors = _occluded_scene()
    grad_pixels = np.random.RandomState(2).randn(H, W, 3).astype(np.float32)
    background = np.zeros((H, W, 3), np.float32)
    grads, debug = dirt_tpu_torch.rasterise_grad_debug(
        background, vertices, colors, faces, grad_pixels, device="cpu")
    want, want_debug = dirt_tpu.rasterise_grad_debug(
        background, vertices, colors, faces, grad_pixels)
    debug = debug.numpy()
    np.testing.assert_array_equal(debug, np.asarray(want_debug))
    assert debug.shape == (H, W, 3)
    # Channel 0: the dilation marker (1e-2 where dilated, 0 elsewhere).
    assert (debug[..., 0] > 0).any(), "no dilation marked at a boundary"
    assert set(np.unique(debug[..., 0])) <= {0.0, np.float32(1e-2)}
    # Channels 1-2 echo the incoming gradient's channels 1-2.
    np.testing.assert_array_equal(debug[..., 1], grad_pixels[..., 1])
    np.testing.assert_array_equal(debug[..., 2], grad_pixels[..., 2])
    assert grads.grad_vertices.shape == (8, 4)
    _close(grads.grad_vertices.numpy(), np.asarray(want.grad_vertices))
