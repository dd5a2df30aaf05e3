"""The port's oracle bindings and single-image forms against dirt_tpu's.

* dirt_tpu_torch.utils.oracle binds the same native library as
  dirt_tpu.utils.oracle: visibility_f64 (the double-precision winner map
  that adjudicates near ties) and rasterise_clipped (the GL polygon-clipping
  oracle) must return what dirt_tpu's bindings return, bit for bit.
* Ports tests/test_native_oracle.py:87 (the f64 map agrees with the f32
  oracle and the reference backend where the pick is well conditioned) and
  tests/test_clipping.py:97 (the two oracles agree on an all-w>0 scene).
* ops.reference.rasterise_single and ops.backward.rasterise_grad_single,
  one-image forms of the batch functions, against dirt_tpu's on one
  tie-free scene: the forward bit for bit, the gradients within 3e-6 of
  max(max |dirt_tpu's|, 1) (the scatters sum in other orders), the
  background gradient and the debug image exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import reference as jreference
from dirt_tpu.utils import oracle as joracle
from dirt_tpu_torch.ops import backward, dispatch, reference
from dirt_tpu_torch.utils import oracle


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TOL = 3e-6


def _random_scene(seed, num_vertices=50, num_faces=35, h=40, w=56, c=3,
                  crossing=False):
    """tests/test_native_oracle.py's scene; `crossing` draws w from
    [-0.5, 1.5), so some faces cross the camera plane."""
    rng = np.random.RandomState(seed)
    v = rng.randn(num_vertices, 4).astype(np.float32)
    v[:, 3] = (rng.uniform(-0.5, 1.5, size=num_vertices) if crossing
               else np.abs(v[:, 3]) + 0.4)
    f = rng.randint(0, num_vertices, size=(num_faces, 3)).astype(np.int32)
    colors = rng.uniform(size=(num_vertices, c)).astype(np.float32)
    bg = rng.uniform(size=(h, w, c)).astype(np.float32)
    return bg, v, colors, f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_visibility_f64_matches_dirt_tpu(seed):
    bg, v, _, f = _random_scene(seed)
    got = oracle.visibility_f64(v, f, *bg.shape[:2])
    np.testing.assert_array_equal(
        got, joracle.visibility_f64(v, f, *bg.shape[:2]))
    assert got.dtype == np.int32 and (got >= 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterise_clipped_matches_dirt_tpu(seed):
    scene = _random_scene(seed, crossing=True)
    got_px, got_idx = oracle.rasterise_clipped(*scene)
    want_px, want_idx = joracle.rasterise_clipped(*scene)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_px, want_px)
    assert (got_idx >= 0).any()


def test_rasterise_clipped_rejects_more_than_eight_channels():
    bg, v, colors, f = _random_scene(0, c=9)
    with pytest.raises(ValueError, match="8 channels"):
        oracle.rasterise_clipped(bg, v, colors, f)


def test_visibility_f64_agrees_on_well_conditioned_scenes():
    bg, verts, colors, faces = _random_scene(23)
    _, idx_f32 = oracle.rasterise(bg, verts, colors, faces)
    idx_f64 = oracle.visibility_f64(verts, faces, bg.shape[0], bg.shape[1])
    np.testing.assert_array_equal(idx_f32, idx_f64)
    _, aux = dispatch.forward_batch(*(torch.tensor(a[None]) for a in (
        bg, verts, colors, faces)), backend="reference")
    np.testing.assert_array_equal(aux.face_index[0].numpy(), idx_f64)


def test_gl_clipping_oracle_agrees_on_ordinary_scene():
    rng = np.random.RandomState(1)
    v = rng.randn(30, 4).astype(np.float32)
    v[:, 3] = np.abs(v[:, 3]) + 0.7
    f = rng.randint(0, 30, size=(20, 3)).astype(np.int32)
    c = rng.uniform(size=(30, 3)).astype(np.float32)
    bg = rng.uniform(size=(40, 64, 3)).astype(np.float32)
    px_a, idx_a = oracle.rasterise(bg, v, c, f)
    px_b, idx_b = oracle.rasterise_clipped(bg, v, c, f)
    disagree = idx_a != idx_b
    # Identical up to fill-rule differences exactly on shared edges.
    assert disagree.mean() < 0.01, disagree.mean()
    same = ~disagree
    np.testing.assert_allclose(px_a[same], px_b[same], atol=2e-3)


# -- rasterise_single and rasterise_grad_single -----------------------------

@pytest.fixture(scope="module")
def single():
    """One tie-free image (seed 3: dirt_tpu's XLA reference and the port
    agree there; see tests/test_torch_forward.py), its forward in both
    packages and an upstream cotangent."""
    scene = _random_scene(3, num_vertices=60, num_faces=40, h=32, w=48)
    want = jreference.rasterise_single(*scene)
    got = reference.rasterise_single(*map(torch.tensor, scene))
    grad_pixels = np.random.RandomState(4).randn(32, 48, 3).astype(
        np.float32)
    return scene, want, got, grad_pixels


def test_rasterise_single_matches_dirt_tpu(single):
    scene, (want_px, want_aux), (got_px, got_aux), _ = single
    np.testing.assert_array_equal(got_px.numpy(), np.asarray(want_px))
    for name in want_aux._fields:
        np.testing.assert_array_equal(getattr(got_aux, name).numpy(),
                                      np.asarray(getattr(want_aux, name)),
                                      err_msg=name)
    assert got_aux.face_index.shape == scene[0].shape[:2]
    assert int(got_aux.dropped) == 0
    np.testing.assert_array_equal(got_aux.face_index.numpy(),
                                  oracle.rasterise(*scene)[1])


@pytest.mark.parametrize("parts", ["all", "position", "color", "cotangent"])
def test_rasterise_grad_single_matches_dirt_tpu(single, parts):
    scene, (want_px, want_aux), (got_px, got_aux), grad_pixels = single
    vertices, faces = scene[1], scene[3]
    kwargs = dict(parts=parts)
    if parts == "cotangent":
        cot = np.random.RandomState(5).randn(32, 48, 5).astype(np.float32)
        kwargs = dict(parts="all", color_cotangent=cot)
    want = jbackward.rasterise_grad_single(
        jnp.asarray(vertices), jnp.asarray(faces), want_px,
        jnp.asarray(grad_pixels), want_aux, **kwargs)
    if "color_cotangent" in kwargs:
        kwargs["color_cotangent"] = torch.tensor(kwargs["color_cotangent"])
    got = backward.rasterise_grad_single(
        torch.tensor(vertices), torch.tensor(faces), got_px,
        torch.tensor(grad_pixels), got_aux, **kwargs)
    for name in ("grad_background", "debug"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("grad_vertices", "grad_vertex_colors"):
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        assert a.shape == b.shape, name
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(b / scale, a / scale, atol=TOL, rtol=0,
                                   err_msg=name)
    if parts in ("all", "position"):
        assert np.abs(got.grad_vertices.numpy()).sum() > 0
    if parts != "position":
        assert np.abs(got.grad_vertex_colors.numpy()).sum() > 0


@pytest.mark.parametrize("kwargs, message", [
    (dict(parts="color", color_cotangent=True), "requires parts='all'"),
    (dict(parts="normals"), "unknown parts"),
])
def test_rasterise_grad_single_rejects_bad_parts(single, kwargs, message):
    scene, _, (got_px, got_aux), grad_pixels = single
    if "color_cotangent" in kwargs:
        kwargs = dict(kwargs, color_cotangent=torch.zeros(32, 48, 3))
    with pytest.raises(ValueError, match=message):
        backward.rasterise_grad_single(
            torch.tensor(scene[1]), torch.tensor(scene[3]), got_px,
            torch.tensor(grad_pixels), got_aux, **kwargs)
