"""Camera-crossing semantics of the port (tests/test_clipping.py's checks).

The scene holds a face with one vertex behind the camera (w < 0), a
visible occluder, a face wholly behind the camera and a face with two
vertices behind.  On the port's CPU backends ("reference", "blocks",
"dense", "pallas", at their GPU tile shapes; the kernels' plain versions)
and gradient implementations ("xla", "blocks", "dense", "mxu"):

  * every backend's winner map equals the native oracle's and dirt_tpu's
    same backend's, pixels within 1e-4; the wholly-behind face is never
    drawn, the crossing faces are;
  * the per-fragment rule agrees with the GL polygon-clipping oracle
    (oracle.rasterise_clipped) everywhere but a one-pixel band at coverage
    boundaries, on under 2% of pixels;
  * autograd's gradients are finite, and each gradient implementation is
    within 3e-6 (normalised) of the port's "xla" scatter and of dirt_tpu's
    same implementation (its kernels in interpret mode).

The same holds for the bench cylinder with the camera inside it, the
full-width crossing scene of chip_smoke.py's phase 4l, at a small size:
its helpers (the scene, the wholly-behind faces, the one-pixel band) are
the ones the card runs.  tests/test_clipping.py's fourth check, the two
oracles on an all-w>0 scene, is in tests/test_torch_oracle.py.
"""

import pathlib
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import grad_blocks as jgrad_blocks
from dirt_tpu.ops import grad_dense as jgrad_dense
from dirt_tpu.ops import grad_mxu as jgrad_mxu
import dirt_tpu_torch
from dirt_tpu_torch.ops import backward, dispatch
from dirt_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


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
BACKENDS = ("reference", "blocks", "dense", "pallas")
BEHIND = 2    # the face wholly behind the camera


def crossing_scene(batch=1):
    """tests/test_clipping.py's 12-vertex scene, [batch, ...] numpy."""
    rng = np.random.RandomState(42)
    v = np.array([
        # Face 0: crosses w = 0 (vertex 2 behind the camera).
        [-0.6, -0.5, 0.2, 1.0], [0.7, -0.4, 0.3, 1.2], [0.1, 0.9, -0.4, -0.8],
        # Face 1: an ordinary visible triangle in front.
        [-0.8, 0.1, 0.0, 1.0], [0.2, -0.8, 0.0, 1.0], [0.6, 0.6, 0.0, 1.0],
        # Face 2: wholly behind the camera (w < 0 at every vertex).
        [-0.5, -0.5, 0.1, -1.0], [0.5, -0.5, 0.1, -1.2], [0.0, 0.7, 0.1, -0.9],
        # Face 3: crosses w = 0 with two vertices behind.
        [0.9, -0.9, 0.5, 1.5], [-0.3, 0.2, -0.2, -0.6], [0.8, 0.8, -0.3, -1.1],
    ], np.float32)
    f = np.arange(12, dtype=np.int32).reshape(4, 3)
    c = rng.uniform(size=(12, 3)).astype(np.float32)
    bg = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    tile = lambda a: np.broadcast_to(a, (batch,) + a.shape).copy()
    return tile(bg), tile(v), tile(c), tile(f)


@pytest.fixture(scope="module")
def port_forward():
    args = [torch.tensor(a) for a in crossing_scene()]
    return {backend: dispatch.forward_batch(*args, backend=backend)
            for backend in BACKENDS}


@pytest.fixture(scope="module")
def jax_reference():
    return jdispatch.forward_batch(*crossing_scene(), backend="reference")


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_agree_bitwise_on_crossing_scene(port_forward, backend):
    bg, v, c, f = crossing_scene()
    pixels, aux = port_forward[backend]
    idx, px = aux.face_index[0].numpy(), pixels[0].numpy()
    want_px, want_idx = oracle.rasterise(bg[0], v[0], c[0], f[0])
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(px, want_px, atol=1e-4, rtol=1e-5)
    jpixels, jaux = jdispatch.forward_batch(bg, v, c, f, backend=backend)
    np.testing.assert_array_equal(idx, np.asarray(jaux.face_index[0]))
    np.testing.assert_allclose(px, np.asarray(jpixels[0]), atol=1e-4,
                               rtol=1e-5)
    assert int(aux.dropped.max()) == 0
    assert not np.any(idx == BEHIND)
    assert np.any(idx == 0) and np.any(idx == 3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_fragment_rule_matches_gl_clipping_oracle(port_forward,
                                                      backend):
    bg, v, c, f = crossing_scene()
    ours = port_forward[backend][1].face_index[0].numpy()
    _, clipped = oracle.rasterise_clipped(bg[0], v[0], c[0], f[0])
    # Finite-precision clipping may move coverage by a pixel at region
    # boundaries: every disagreement lies within one pixel (Chebyshev) of
    # a boundary of the clipped map, and they are a band, not a region.
    disagree, stray = chip_smoke.clipped_disagreement(ours, clipped)
    assert stray == 0, f"{stray} disagreements away from region boundaries"
    assert disagree / ours.size < 0.02, disagree / ours.size
    assert not np.any(clipped == BEHIND)


def test_autograd_gradients_finite_on_crossing_scene():
    bg, v, c, f = (torch.tensor(a) for a in crossing_scene())
    leaves = [x.clone().requires_grad_(True) for x in (v, c, bg)]
    pixels = dirt_tpu_torch.rasterise_batch(leaves[2], leaves[0], leaves[1],
                                            f)
    (pixels * pixels).sum().backward()
    for leaf in leaves:
        assert torch.isfinite(leaf.grad).all()
    assert float(leaves[0].grad.abs().sum()) > 0


JAX_GRADS = {
    "xla": lambda *a: jbackward.rasterise_grad_batch(*a,
                                                     implementation="xla"),
    "blocks": lambda *a: jgrad_blocks.rasterise_grad_batch(*a,
                                                           interpret=True),
    "dense": lambda *a: jgrad_dense.rasterise_grad_batch(*a, interpret=True),
    "mxu": lambda *a: jgrad_mxu.rasterise_grad_batch(*a, interpret=True),
}


@pytest.mark.parametrize("implementation", sorted(JAX_GRADS))
def test_gradient_implementations_agree_on_crossing_scene(
        port_forward, jax_reference, implementation):
    bg, v, c, f = crossing_scene()
    pixels, aux = port_forward["reference"]
    gp = np.random.RandomState(9).randn(*bg.shape).astype(np.float32)
    args = (torch.tensor(v), torch.tensor(f), pixels, torch.tensor(gp), aux)
    plain = backward.rasterise_grad_batch(*args, implementation="xla")
    got = backward.rasterise_grad_batch(*args, implementation=implementation)
    jpixels, jaux = jax_reference
    want = JAX_GRADS[implementation](jnp.asarray(v), jnp.asarray(f), jpixels,
                                     jnp.asarray(gp), jaux)
    for name in ("grad_background", "grad_vertices", "grad_vertex_colors"):
        b = getattr(got, name).numpy()
        assert np.isfinite(b).all(), name
        for ref in (getattr(plain, name).numpy(),
                    np.asarray(getattr(want, name))):
            scale = max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(b / scale, ref / scale, atol=TOL,
                                       rtol=0, err_msg=name)
    assert float(got.grad_vertices.abs().sum()) > 0


def test_chip_smoke_scene_is_the_test_scene():
    for got, want in zip(chip_smoke.clip_test_scene("cpu"),
                         crossing_scene()):
        np.testing.assert_array_equal(got.numpy(), want)
    _, v, _, f = crossing_scene()
    assert chip_smoke.behind_faces(torch.tensor(v), torch.tensor(f)).tolist() \
        == [[False, False, True, False]]


@pytest.mark.parametrize("backend", ["blocks", "dense", "pallas"])
def test_camera_inside_cylinder(backend):
    background, clip, colors, faces, _ = chip_smoke.bench_scene(
        2, 64, 16, "cpu", distance=chip_smoke.CROSSING_DISTANCE)
    behind = chip_smoke.behind_faces(clip, faces)
    assert int(behind.sum()) > 0
    pixels, aux = dispatch.forward_batch(background, clip, colors, faces,
                                         backend=backend)
    assert int(aux.dropped.max()) == 0
    for b in range(2):
        image = [t[b].numpy() for t in (background, clip, colors, faces)]
        want_px, want_index = oracle.rasterise(*image)
        index = aux.face_index[b].numpy()
        np.testing.assert_array_equal(index, want_index)
        np.testing.assert_allclose(pixels[b].numpy(), want_px, atol=1e-4,
                                   rtol=1e-5)
        assert not behind[b].numpy()[index[index >= 0]].any()
        _, clipped = oracle.rasterise_clipped(*image)
        disagree, stray = chip_smoke.clipped_disagreement(index, clipped)
        assert stray == 0
        assert disagree / index.size < chip_smoke.CLIPPED_SHARE
        assert (index >= 0).mean() > 0.5
