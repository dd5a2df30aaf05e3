"""Deferred shading and rasterise_grad_debug of dirt_tpu_torch against
dirt_tpu's, on the CPU.

The cases of tests/test_deferred.py and tests/test_deferred_fused.py, run
through both packages on the same numpy scene.  Gradients are compared as
tests/test_grad_kernels.py compares dirt_tpu's own backends, within
max |a - b| / max(max |a|, 1) <= 3e-6: the two packages differentiate the
shader with their own autodiff and sum in different orders.  The fused
deferred backward must equal the two-call form (parts "position" +
"color") bit for bit for every gradient implementation, as dirt_tpu pins
it: on the CPU every sum runs in a fixed order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
import dirt_tpu_torch
from dirt_tpu_torch.ops import backward, dispatch


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


H, W = 24, 32
TOL = 3e-6


def _scene():
    """tests/test_deferred.py's scene: two triangles of a quad, in numpy."""
    vertices = np.array([
        [-0.5, -0.5, 0., 1.],
        [-0.5, 0.5, 0., 1.],
        [0.5, 0.5, 0.4, 2.],
        [0.5, -0.5, 0.4, 2.],
    ], np.float32)
    vertices[2:, :2] *= 2.0
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.RandomState(0)
    attrs = rng.uniform(0.2, 0.9, size=(4, 3)).astype(np.float32)
    bg = rng.uniform(size=(H, W, 3)).astype(np.float32)
    return vertices, faces, attrs, bg


def _close(want, got, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL,
                               err_msg=name)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _deferred(bg, v, a, f, shader, inputs=()):
    return dirt_tpu_torch.rasterise_deferred(
        bg, v, a, f, shader_fn=shader, shader_additional_inputs=inputs,
        device="cpu")


# -- tests/test_deferred.py ------------------------------------------------

def test_linear_shader_commutes_with_direct():
    v, f, a, bg = _scene()
    m = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    got = _deferred(bg, v, a, f, lambda gb, mat: gb @ mat,
                    [torch.as_tensor(m)])
    direct = dirt_tpu_torch.rasterise(bg @ m, v, a @ m, f, device="cpu")
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)
    want = dirt_tpu.rasterise_deferred(
        bg, v, a, f, shader_fn=lambda gb, mat: gb @ mat,
        shader_additional_inputs=[jnp.asarray(m)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_deferred_vertex_grads_filter_shaded_image():
    v, f, a, bg = _scene()
    weights = np.random.RandomState(2).randn(H, W, 3).astype(np.float32)

    vt = _leaf(v)
    (_deferred(bg, vt, a, f, lambda gb: gb ** 2 + 0.1 * gb)
     * torch.as_tensor(weights)).sum().backward()
    want = jax.grad(lambda vv: jnp.sum(dirt_tpu.rasterise_deferred(
        bg, vv, a, f, shader_fn=lambda gb: gb ** 2 + 0.1 * gb) * weights))(
        jnp.asarray(v))
    _close(want, vt.grad, "deferred vertex gradient")

    # The gradient assembly run on the SHADED pixels gives it ...
    gbuffer, aux = dispatch.forward_batch(
        *(torch.as_tensor(x)[None] for x in (bg, v, a, f)))
    shaded = gbuffer ** 2 + 0.1 * gbuffer
    _, manual, _ = backward.rasterise_grad_grouped(
        torch.as_tensor(v)[None], torch.as_tensor(f)[None], shaded,
        torch.as_tensor(weights)[None], aux)
    np.testing.assert_allclose(vt.grad.numpy(), manual[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    # ... and the naive pipeline, which filters the G-buffer, does not.
    naive = _leaf(v)
    px = dirt_tpu_torch.rasterise(bg, naive, a, f)
    ((px ** 2 + 0.1 * px) * torch.as_tensor(weights)).sum().backward()
    assert not np.allclose(naive.grad.numpy(), vt.grad.numpy(), rtol=0.05)


def test_deferred_attribute_grads_chain_through_shader():
    v, f, a, bg = _scene()
    m = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    weights = np.random.RandomState(3).randn(H, W, 3).astype(np.float32)
    at = _leaf(a)
    (_deferred(bg, v, at, f, lambda gb, mat: gb @ mat, [torch.as_tensor(m)])
     * torch.as_tensor(weights)).sum().backward()
    colors = _leaf(a @ m)
    (dirt_tpu_torch.rasterise(bg @ m, v, colors, f)
     * torch.as_tensor(weights)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), colors.grad.numpy() @ m.T,
                               rtol=1e-4, atol=1e-5)
    want = jax.grad(lambda aa: jnp.sum(dirt_tpu.rasterise_deferred(
        bg, v, aa, f, shader_fn=lambda gb, mat: gb @ mat,
        shader_additional_inputs=[jnp.asarray(m)]) * weights))(
        jnp.asarray(a))
    _close(want, at.grad, "attribute gradient")


def _light_loss(light, closure):
    v, f, a, bg = _scene()
    if closure:
        px = _deferred(bg, v, a, f, lambda gb: gb ** 2 * light)
    else:
        px = _deferred(bg, v, a, f, lambda gb, lc: gb ** 2 * lc, [light])
    return (px ** 2).sum()


def test_shader_additional_input_gradient():
    light = _leaf(np.array([0.8, 0.6, 0.4], np.float32))
    _light_loss(light, closure=False).backward()
    v, f, a, bg = _scene()
    want = jax.grad(lambda lc: jnp.sum(dirt_tpu.rasterise_deferred(
        bg, v, a, f, shader_fn=lambda gb, l: gb ** 2 * l,
        shader_additional_inputs=[lc]) ** 2))(jnp.asarray([0.8, 0.6, 0.4]))
    _close(want, light.grad, "light")
    with torch.no_grad():
        eps = 1e-2
        d = torch.tensor([0., eps, 0.])
        fd = (_light_loss(light + d, False)
              - _light_loss(light - d, False)) / (2 * eps)
    np.testing.assert_allclose(float(light.grad[1]), float(fd), rtol=5e-3)


def test_closed_over_tensor_gradient_matches_additional_inputs():
    closed = _leaf(np.array([0.8, 0.6, 0.4], np.float32))
    _light_loss(closed, closure=True).backward()
    explicit = _leaf(np.array([0.8, 0.6, 0.4], np.float32))
    _light_loss(explicit, closure=False).backward()
    assert float(explicit.grad.abs().sum()) > 1e-3
    np.testing.assert_allclose(closed.grad.numpy(), explicit.grad.numpy(),
                               rtol=1e-6)


def test_closed_over_scalar_gets_the_shader_gradient():
    v, f, a, bg = _scene()

    def loss(gain):
        return _deferred(bg, v, a, f, lambda gb: torch.tanh(gb * gain)).sum()

    gain = _leaf(np.float32(1.7))
    loss(gain).backward()
    want = jax.grad(lambda g: jnp.sum(dirt_tpu.rasterise_deferred(
        bg, v, a, f, shader_fn=lambda gb: jnp.tanh(gb * g))))(
        jnp.asarray(1.7))
    _close(want, gain.grad, "gain")
    with torch.no_grad():
        fd = (loss(gain + 1e-2) - loss(gain - 1e-2)) / 2e-2
    np.testing.assert_allclose(float(gain.grad), float(fd), rtol=1e-3)


def test_closure_combines_with_additional_inputs_and_int_closures():
    v, f, a, bg = _scene()
    gain = _leaf(np.float32(1.3))
    light = _leaf(np.array([0.8, 0.6, 0.4], np.float32))
    px = _deferred(bg, v, a, f, lambda gb, lc: torch.tanh(gb * gain) * lc,
                   [light])
    (px ** 2).sum().backward()
    want_gain, want_light = jax.grad(
        lambda g, lc: jnp.sum(dirt_tpu.rasterise_deferred(
            bg, v, a, f, shader_fn=lambda gb, l: jnp.tanh(gb * g) * l,
            shader_additional_inputs=[lc]) ** 2), argnums=(0, 1))(
        jnp.asarray(1.3), jnp.asarray([0.8, 0.6, 0.4]))
    _close(want_gain, gain.grad, "gain")
    _close(want_light, light.grad, "light")
    assert float(light.grad.abs().sum()) > 1e-4

    sel = torch.tensor([0, 1, 2])
    light2 = _leaf(np.array([0.8, 0.6, 0.4], np.float32))
    (_deferred(bg, v, a, f, lambda gb: gb[..., sel] * light2) ** 2
     ).sum().backward()
    assert bool(torch.isfinite(light2.grad).all())
    assert float(light2.grad.abs().sum()) > 0


def test_batch_deferred_matches_single():
    v, f, a, bg = _scene()
    shader = lambda gb: torch.sqrt(gb.abs() + 0.1)
    single = _deferred(bg, v, a, f, shader)
    batched = dirt_tpu_torch.rasterise_batch_deferred(
        np.stack([bg, bg]), np.stack([v, v]), np.stack([a, a]),
        np.stack([f, f]), shader_fn=shader, device="cpu")
    assert torch.equal(batched[0], single) and torch.equal(batched[1], single)


def test_shaded_pixels_off_the_loss_path_count_as_zero():
    # The loss reads only the G-buffer (leaked by the shader): the shaded
    # pixels' cotangent never arrives, and the fused backward takes it as
    # zeros -- attribute gradients flow, vertex gradients are zero.
    v, f, a, bg = _scene()
    leaked = []

    def shader(gb):
        leaked.append(gb)
        return gb * 2.0

    vt, at = _leaf(v), _leaf(a)
    _deferred(bg, vt, at, f, shader)
    leaked[0].sum().backward()
    assert int(torch.count_nonzero(vt.grad)) == 0
    assert float(at.grad.abs().sum()) > 0


# -- tests/test_deferred_fused.py ------------------------------------------

def _fused_scene(seed, attrs, batch=2, nv=48, nf=40, h=40, w=64):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = np.abs(v[..., 3]) + 0.5
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    a = rng.uniform(size=(batch, nv, attrs)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, attrs)).astype(np.float32)
    return rng, [torch.as_tensor(x) for x in (v, f, a, bg)]


def _fused_and_two_call(seed, attrs, shader, implementation):
    rng, (v, f, a, bg) = _fused_scene(seed, attrs)
    gbuffer, aux = dispatch.forward_batch(bg, v, a, f, "dense")
    gbuffer.requires_grad_(True)
    pixels = shader(gbuffer)
    grad_pixels = torch.as_tensor(
        rng.randn(*pixels.shape).astype(np.float32))
    (grad_gbuffer,) = torch.autograd.grad(pixels, gbuffer, grad_pixels)
    pixels, gbuffer = pixels.detach(), gbuffer.detach()

    _, grad_vertices, _ = backward.rasterise_grad_grouped(
        v, f, pixels, grad_pixels, aux, parts="position",
        implementation=implementation)
    grad_background, _, grad_attrs = backward.rasterise_grad_grouped(
        v, f, gbuffer, grad_gbuffer, aux, parts="color",
        implementation=implementation)
    fused = backward.rasterise_grad_deferred(
        v, f, pixels, grad_pixels, gbuffer, grad_gbuffer, aux,
        implementation=implementation)
    return (grad_background, grad_vertices, grad_attrs), fused


@pytest.mark.parametrize("implementation", ["xla", "blocks", "dense"])
@pytest.mark.parametrize("attrs", [3, 7])
def test_fused_deferred_bitwise_vs_two_call(implementation, attrs):
    light = torch.as_tensor(
        np.random.RandomState(21).uniform(0.2, 1.0, size=attrs),
        dtype=torch.float32)
    two_call, fused = _fused_and_two_call(
        21, attrs, lambda gb: torch.tanh(gb * light)[..., :3],
        implementation)
    for name, want, got in zip(("background", "vertices", "attributes"),
                               two_call, fused):
        assert torch.equal(want, got), (name, implementation, attrs)
    assert float(fused[1].abs().max()) > 0


@pytest.mark.parametrize("shaded", [2, 4])
def test_fused_deferred_wide_and_split_shaded_groups(shaded):
    # Shaded images of 2 (groups 1+1) and 4 channels (groups 3+1): the
    # position half sums per-group Scharr rows in the two-call order, and
    # every G-buffer channel rides the first group's sweep.
    if shaded == 2:
        shader = lambda gb: torch.stack(
            [torch.tanh(gb).sum(-1), (gb ** 2).sum(-1)], dim=-1)
        attrs = 4
    else:
        shader = lambda gb: gb[..., :4] ** 2 + 0.3 * gb[..., 3:]
        attrs = 7
    for implementation in ("xla", "dense"):
        two_call, fused = _fused_and_two_call(5, attrs, shader,
                                              implementation)
        for want, got in zip(two_call, fused):
            assert torch.equal(want, got), implementation


def test_unported_and_unknown_implementations_raise():
    _, (v, f, a, bg) = _fused_scene(9, 3)
    gbuffer, aux = dispatch.forward_batch(bg, v, a, f, "reference")
    for name in ("mosaic", "nope"):
        with pytest.raises(ValueError, match=name):
            backward.rasterise_grad_deferred(v, f, gbuffer, gbuffer, gbuffer,
                                             gbuffer, aux,
                                             implementation=name)
    with pytest.raises(ValueError, match="parts"):
        backward.rasterise_grad_batch(v, f, gbuffer, gbuffer, aux,
                                      implementation="xla", parts="color",
                                      color_cotangent=gbuffer)


def test_end_to_end_deferred_matches_jax_four_channels():
    # A 4-channel G-buffer through the whole deferred step of both
    # packages (dirt_tpu's fused backward on its CPU default, "xla").
    _, (v, f, a, bg) = _fused_scene(12, 4, batch=1)
    light = np.array([0.8, 0.6, 0.4, 0.2], np.float32)
    vt, at = _leaf(v.numpy()), _leaf(a.numpy())
    (dirt_tpu_torch.rasterise_batch_deferred(
        bg, vt, at, f, shader_fn=lambda gb: torch.tanh(
            gb * torch.as_tensor(light))) ** 2).sum().backward()
    want_v, want_a = jax.grad(lambda vv, aa: jnp.sum(
        dirt_tpu.rasterise_batch_deferred(
            bg.numpy(), vv, aa, f.numpy(),
            shader_fn=lambda gb: jnp.tanh(gb * light)) ** 2),
        argnums=(0, 1))(jnp.asarray(v.numpy()), jnp.asarray(a.numpy()))
    _close(want_v, vt.grad, "vertices")
    _close(want_a, at.grad, "attributes")


@pytest.mark.parametrize("backend", ["blocks", "dense"])
def test_deferred_step_on_each_backend_matches_reference(backend):
    # The deferred autograd path with the kernels' backends (their plain
    # versions here) against the CPU default (reference forward, "xla"
    # gradient), closure gradient included.
    _, (v, f, a, bg) = _fused_scene(14, 7)
    weights = torch.as_tensor(np.random.RandomState(15).randn(
        *bg.shape[:3], 3).astype(np.float32))
    grads = {}
    for name in ("reference", backend):
        vt, at = _leaf(v.numpy()), _leaf(a.numpy())
        light = _leaf(np.array([0.3, -0.5, -0.8, 0.1, 0.2, 0.4, 0.6],
                               np.float32))
        px = dirt_tpu_torch.rasterise_batch_deferred(
            bg, vt, at, f, lambda gb: torch.tanh(gb * light)[..., :3],
            backend=name)
        (px * weights).sum().backward()
        grads[name] = (px.detach(), vt.grad, at.grad, light.grad)
    want, got = grads["reference"], grads[backend]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-4,
                               rtol=1e-5)
    for name, a_, b_ in zip(("vertices", "attributes", "light"), want[1:],
                            got[1:]):
        _close(a_.numpy(), b_, name)
    assert float(got[3].abs().sum()) > 0


# -- rasterise_grad_debug --------------------------------------------------

@pytest.mark.parametrize("implementation", ["xla", "dense"])
def test_grad_debug_matches_jax(implementation):
    rng, (v, f, c, bg) = _fused_scene(17, 3, batch=1)
    gp = rng.randn(*bg.shape[1:]).astype(np.float32)
    args = (bg[0].numpy(), v[0].numpy(), c[0].numpy(), f[0].numpy(), gp)
    want, want_debug = dirt_tpu.rasterise_grad_debug(
        *args, grad_implementation=implementation)
    got, debug = dirt_tpu_torch.rasterise_grad_debug(
        *args, grad_implementation=implementation, device="cpu")
    np.testing.assert_array_equal(np.asarray(want_debug), debug.numpy())
    assert float(debug[..., 0].max()) == pytest.approx(1e-2)
    np.testing.assert_array_equal(np.asarray(want.grad_background),
                                  got.grad_background.numpy())
    _close(want.grad_vertices, got.grad_vertices, "vertices")
    _close(want.grad_vertex_colors, got.grad_vertex_colors, "colours")
    assert got.grad_vertices.shape == v.shape[1:]
