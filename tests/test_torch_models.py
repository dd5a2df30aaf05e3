"""dirt_tpu_torch.models (the renderer pipelines) against dirt_tpu.models,
on the CPU, and tests/test_models.py's cases on the port.

Each renderer renders the same numpy scene at 64x48 in both packages:
pixels within 1e-4 (the scene math -- rotations, normals, the camera
matrices -- rounds in another order, and the rasteriser's interpolation
carries it), and the gradients of sum(pixels * weights) by jax.grad and by
autograd within 1e-4 of max |grad| (the same filter-based gradients,
summed in another order).  The gradients go to the object rotation
(Gouraud), the light direction (Phong), and the texture and the light
(Textured).  The Gouraud rotation gradient reaches the occluder
dilation, whose exact compares make it jump with an ulp of the scene
math, so JAX's is taken where its rasteriser sees the port's clip and
lit values (_gouraud says why); the cube's top and bottom faces meet the
light (1, 0, 0) at n . l == 0 exactly, so it also holds the port's |x|
to jnp.abs's gradient at 0.  The port's renderer built by
utils.convert.renderer_from_config from the JAX renderer's fields must
render what the JAX renderer renders.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
from dirt_tpu import lighting as jlighting
from dirt_tpu import matrices as jmatrices
from dirt_tpu import models as jmodels
from dirt_tpu.utils import meshes
from dirt_tpu_torch import lighting, models
from dirt_tpu_torch.utils.convert import renderer_from_config


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


W, H = 64, 48
PIXEL_TOL = 1e-4
GRAD_TOL = 1e-4
ROTATION = np.array([0., 0.5, 0.], np.float32)
LIGHT = np.array([1., -0.3, -0.5], np.float32) / np.linalg.norm(
    [1., -0.3, -0.5]).astype(np.float32)


def _cube():
    """The split-vertex cube (numpy): vertices [36, 3], faces [12, 3]."""
    v, f = meshes.build_cube()
    v, f = jlighting.split_vertices_by_face(jnp.asarray(v), jnp.asarray(f))
    return np.asarray(v), np.asarray(f)


def _textured_scene():
    """tests/test_models.py's textured scene: the unsplit cube with random
    uvs and a random 32x32 texture."""
    rng = np.random.RandomState(0)
    v, f = meshes.build_cube()
    uvs = rng.uniform(size=(8, 2)).astype(np.float32)
    texture = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    return v, f, uvs, texture


def _weights(seed=1):
    return np.random.RandomState(seed).uniform(
        0.5, 1.5, size=(H, W, 3)).astype(np.float32)


def _close_pixels(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape == (H, W, 3)
    err = float(np.abs(got - want).max())
    assert err <= PIXEL_TOL, err


def _close_grad(got, want, name):
    got, want = got.detach().numpy(), np.asarray(want)
    assert np.isfinite(got).all(), name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max()) / scale
    assert err <= GRAD_TOL, (name, err)


def _compare(jrender, trender, arrays, grad_args):
    """Pixels of jrender(*arrays) and trender(*arrays), then the gradients
    of sum(pixels * weights) wrt arrays[i], i in grad_args."""
    w = _weights()
    want = jrender(*[jnp.asarray(a) for a in arrays])
    leaves = [torch.tensor(a, requires_grad=i in grad_args)
              for i, a in enumerate(arrays)]
    got = trender(*leaves)
    _close_pixels(got, want)
    want_grads = jax.grad(lambda *a: jnp.sum(jrender(*a) * w),
                          argnums=tuple(grad_args))(
        *[jnp.asarray(a) for a in arrays])
    (got * torch.as_tensor(w)).sum().backward()
    for i, want_grad in zip(grad_args, want_grads):
        _close_grad(leaves[i].grad, want_grad, f"grad of argument {i}")


def _jax_gouraud_scene(jmodel, v, f, albedo, rotation):
    """dirt_tpu's GouraudRenderer.render up to the rasteriser, step for
    step: (clip, lit)."""
    vertices = jnp.concatenate([v, jnp.ones_like(v[:, :1])], axis=-1)
    world = vertices @ jmatrices.rodrigues(rotation)
    normals = jlighting.vertex_normals_pre_split(world, f)
    view, projection = jmodel.camera.matrices(jmodel.width, jmodel.height)
    lit = jlighting.diffuse_directional(
        normals, albedo, jnp.asarray(jmodel.light_direction),
        jnp.asarray(jmodel.light_color)) * (1. - jmodel.ambient) \
        + albedo * jmodel.ambient
    return world @ view @ projection, lit


def _jax_gouraud(jmodel, v, f, albedo, rotation, values=None):
    """dirt_tpu's GouraudRenderer.render, step for step; with `values`
    (clip, lit), the rasteriser sees those values while the derivative
    stays JAX's (x + stop_gradient(value - x))."""
    clip, lit = _jax_gouraud_scene(jmodel, v, f, albedo, rotation)
    if values is not None:
        clip, lit = (x + jax.lax.stop_gradient(jnp.asarray(value) - x)
                     for x, value in zip((clip, lit), values))
    return dirt_tpu.rasterise(jnp.zeros((H, W, 3)), clip, lit, f,
                              backend=jmodel.backend)


def _gouraud(jmodel, tmodel):
    """The rotation gradient goes through the clip vertices into the
    occluder dilation, whose axis is an exact compare of Scharr
    magnitudes (l1_x > l1_y): an ulp of difference in the scene math (XLA
    contracts its CPU dot into FMAs, torch's matmul rounds otherwise)
    moves it at a few diagonal-edge pixels, and the gradient by up to
    ~2e-3 of its max.  So the port's gradient is held against JAX's
    derivative taken where the rasteriser sees the port's clip and lit
    values (and that stand-in against dirt_tpu's renderer itself), and
    the scene values against JAX's."""
    v, f = _cube()
    albedo = np.ones_like(v)
    jv, jf, jalbedo = jnp.asarray(v), jnp.asarray(f), jnp.asarray(albedo)
    jrot = jnp.asarray(ROTATION)
    w = _weights()
    want = jmodel.render(jv, jf, jalbedo, jrot)
    np.testing.assert_array_equal(
        np.asarray(_jax_gouraud(jmodel, jv, jf, jalbedo, jrot)),
        np.asarray(want))

    rotation = torch.tensor(ROTATION, requires_grad=True)
    _, clip, lit, _ = tmodel.scene(v, f, albedo, rotation)
    j_clip, j_lit = (np.asarray(x) for x in _jax_gouraud_scene(
        jmodel, jv, jf, jalbedo, jrot))
    for got, want_value in ((clip, j_clip), (lit, j_lit)):
        err = float(np.abs(got.detach().numpy() - want_value).max())
        assert err <= 1e-6 * max(float(np.abs(want_value).max()), 1.), err

    got = tmodel.render(v, f, albedo, rotation)
    _close_pixels(got, want)
    values = (clip.detach().numpy(), lit.detach().numpy())
    want_grad = jax.grad(lambda r: jnp.sum(_jax_gouraud(
        jmodel, jv, jf, jalbedo, r, values) * w))(jrot)
    (got * torch.as_tensor(w)).sum().backward()
    _close_grad(rotation.grad, want_grad, "rotation")


def _phong(jmodel, tmodel):
    v, f = _cube()
    albedo = np.ones_like(v)
    _compare(lambda l: jmodel.render(v, f, albedo, ROTATION, l),
             lambda l: tmodel.render(v, f, albedo, ROTATION, l), [LIGHT],
             [0])


def _textured(jmodel, tmodel):
    v, f, uvs, texture = _textured_scene()
    rotation = np.array([0.2, 0.7, 0.], np.float32)
    _compare(lambda t, l: jmodel.render(v, f, uvs, t, rotation, l),
             lambda t, l: tmodel.render(v, f, uvs, t, rotation, l),
             [texture, LIGHT], [0, 1])


CASES = {"GouraudRenderer": _gouraud, "DeferredPhongRenderer": _phong,
         "TexturedRenderer": _textured}
# Fields other than the defaults, for each renderer.
OTHER_FIELDS = {
    "GouraudRenderer": dict(
        camera=jmodels.renderers.Camera(translation=(0.1, -1.2, -3.0),
                                        rotation=(-0.2, 0.1, 0.)),
        light_direction=(0.6, -0.8, 0.), light_color=(1., 0.5, 0.25),
        ambient=0.3),
    "DeferredPhongRenderer": dict(
        diffuse_color=(0.2, 0.9, 0.4), specular_color=(0.5, 0.5, 1.),
        background_color=(0.1, 0.2, 0.), shininess=4., ambient=0.1),
    "TexturedRenderer": dict(
        light_color=(0.8, 0.7, 0.6), background_color=(0.2, 0., 0.),
        ambient=0.25, normals_fn=jlighting.vertex_normals_pre_split),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_renderer_matches_dirt_tpu(kind):
    jmodel = getattr(jmodels, kind)(width=W, height=H)
    tmodel = getattr(models, kind)(width=W, height=H)
    CASES[kind](jmodel, tmodel)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_renderer_from_config_matches_dirt_tpu(kind):
    jmodel = getattr(jmodels, kind)(width=W, height=H, **OTHER_FIELDS[kind])
    tmodel = renderer_from_config(kind, dataclasses.asdict(jmodel))
    assert isinstance(tmodel, getattr(models, kind))
    assert [f.name for f in dataclasses.fields(tmodel)] == [
        f.name for f in dataclasses.fields(jmodel)]
    if kind == "TexturedRenderer":
        assert tmodel.normals_fn is lighting.vertex_normals_pre_split
    CASES[kind](jmodel, tmodel)


def test_fields_and_defaults_are_dirt_tpus():
    for kind in CASES:
        jfields = dataclasses.fields(getattr(jmodels, kind))
        tfields = dataclasses.fields(getattr(models, kind))
        assert [f.name for f in tfields] == [f.name for f in jfields]
        for jf, tf in zip(jfields, tfields):
            if jf.name == "normals_fn":
                assert tf.default is lighting.vertex_normals
            elif jf.name != "camera":
                assert tf.default == jf.default, (kind, jf.name)
    assert dataclasses.asdict(models.Camera()) == dataclasses.asdict(
        jmodels.renderers.Camera())


def test_renderer_from_config_rejects_unknown():
    with pytest.raises(ValueError):
        renderer_from_config("PathTracer", {"width": W, "height": H})
    with pytest.raises(ValueError):
        renderer_from_config("TexturedRenderer", {
            "width": W, "height": H, "normals_fn": lambda v, f: v})


# -- tests/test_models.py on the port --------------------------------------

def _torch_cube():
    v, f = _cube()
    return torch.as_tensor(v), torch.as_tensor(f)


def test_gouraud_renderer_module_and_grad():
    v, f = _torch_cube()
    albedo = torch.ones(v.shape[0], 3)
    model = models.GouraudRenderer(width=W, height=H)
    rot = torch.tensor([0., 0.5, 0.], requires_grad=True)
    pixels = model(v, f, albedo, rot)
    assert pixels.shape == (H, W, 3)
    assert float(pixels.max()) > 0.1
    (pixels ** 2).sum().backward()
    assert bool(torch.isfinite(rot.grad).all())
    assert float(rot.grad.abs().sum()) > 0


def test_deferred_phong_renderer_highlights():
    v, f = _torch_cube()
    albedo = torch.ones(v.shape[0], 3)
    model = models.DeferredPhongRenderer(width=W, height=H)
    light = torch.tensor(LIGHT, requires_grad=True)
    pixels = model.render(v, f, albedo, torch.tensor([0., 0.5, 0.]), light)
    assert pixels.shape == (H, W, 3)
    # Specular highlights saturate some pixels towards white; background
    # blue.
    assert float(pixels[..., 2].max()) >= 0.299
    assert float(pixels[..., 0].max()) > 0.5
    pixels.sum().backward()
    assert float(light.grad.abs().sum()) > 1e-3


def test_textured_renderer_texture_grads():
    v, f, uvs, texture = _textured_scene()
    model = models.TexturedRenderer(width=W, height=H)
    texture = torch.tensor(texture, requires_grad=True)
    pixels = model.render(v, f, uvs, texture, [0.2, 0.7, 0.], LIGHT,
                          device="cpu")
    pixels.sum().backward()
    assert float(texture.grad.abs().sum()) > 0.01


def test_camera_matrices_on_the_device_asked():
    view, projection = models.Camera().matrices(W, H, device="cpu")
    assert view.device.type == projection.device.type == "cpu"
    jview, jprojection = jmodels.renderers.Camera().matrices(W, H)
    np.testing.assert_allclose(view.numpy(), np.asarray(jview), atol=1e-6)
    np.testing.assert_allclose(projection.numpy(), np.asarray(jprojection),
                               atol=1e-6)


def test_chip_smoke_gouraud_reference_is_the_models_gradient():
    """chip_smoke's phase 4i holds the card's Gouraud rotation gradient
    against gouraud_reference: given the CPU's own clip and lit values it
    must be the model's autograd gradient."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = smoke.model_cases()
    assert sorted(cases) == ["gouraud cube", "gouraud cylinder 512f",
                             "phong cube", "textured prism"]
    model, arrays, grads, compared = cases["gouraud cube"]
    weights = smoke.model_weights("cpu")
    _, want = smoke.model_step(model, arrays, grads, weights)
    with torch.no_grad():
        _, clip, lit, _ = model.scene(*smoke.model_args(arrays, (), "cpu"))
    got = smoke.gouraud_reference(model, arrays, grads, weights, clip, lit)
    assert compared == grads == (3,)
    assert torch.equal(got[0], want[0]) and float(want[0].abs().max()) > 0
