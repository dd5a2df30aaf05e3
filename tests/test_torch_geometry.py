"""dirt_tpu_torch.ops.geometry against dirt_tpu.ops.geometry on the CPU.

The face constants decide every coverage test, so they must be bitwise
equal: e (the edge coefficients, whose exact antisymmetry across shared
edges gives exactly-once rasterisation), accept (the fill rule) and valid.
The JAX module protects the cross-product terms with optimization
barriers; the port relies on eager PyTorch rounding each product on its
own.  Scenes at non-dyadic axis-aligned coordinates (two_squares) are the
stress test (the numerical-precision rule 3: exact comparisons with 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import geometry as jgeometry
from dirt_tpu_torch.ops import geometry
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


def _soup(seed, batch=2, nv=40, nf=64, crossing=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    return v, f


def _two_squares():
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, front_offset=0.45, size=0.4,
        back_size=0.45)
    return verts[None], faces[None]


def _cylinder():
    v, f = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, 8)
    v = np.concatenate([v * 0.6, np.full((v.shape[0], 1), 1.5, np.float32)],
                       axis=1)
    return v[None], f[None]


SCENES = {
    "soup0": lambda: _soup(0),
    "soup1": lambda: _soup(1),
    "crossing": lambda: _soup(2, crossing=True),
    "two_squares": _two_squares,
    "cylinder": _cylinder,
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_face_setup_bitwise(scene):
    v, f = SCENES[scene]()
    want = jgeometry.face_setup(jnp.asarray(v), jnp.asarray(f))
    got = geometry.face_setup(torch.as_tensor(v), torch.as_tensor(f))
    for name in ("e", "z", "w", "accept", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    # The bitwise property the rasteriser relies on: a shared edge's
    # coefficients are exact negations in the two faces that share it.
    if scene == "two_squares":
        e = got.e.numpy()[0]
        # faces [0,1,2] and [0,2,3] share the edge 0-2: edge 1 of face 0
        # (cross(p2, p0)) and edge 2 of face 1 (cross(p0, p2)).
        np.testing.assert_array_equal(e[0, 1], -e[1, 2])


@pytest.mark.parametrize("height,width", [(64, 128), (48, 80), (100, 100)])
def test_pixel_centre_ndc_bitwise(height, width):
    want = jgeometry.pixel_centre_ndc(height, width)
    got = geometry.pixel_centre_ndc(height, width)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("scene", ["soup0", "crossing", "two_squares"])
def test_fragment_math_bitwise(scene):
    v, f = SCENES[scene]()
    v, f = v[0], f[0]
    height, width = 24, 40
    js = jgeometry.face_setup(jnp.asarray(v), jnp.asarray(f))
    ts = geometry.face_setup(torch.as_tensor(v), torch.as_tensor(f))
    jx, jy = jgeometry.pixel_centre_ndc(height, width)
    tx, ty = geometry.pixel_centre_ndc(height, width)
    colors = np.random.RandomState(4).uniform(size=(f.shape[0], 3, 2))
    colors = colors.astype(np.float32)
    for k in range(min(f.shape[0], 6)):
        jcov, jdep = jgeometry.fragment_cover_depth(
            js.e[k], js.z[k], js.w[k], js.accept[k], js.valid[k],
            jx[None, :], jy[:, None])
        tcov, tdep = geometry.fragment_cover_depth(
            ts.e[k], ts.z[k], ts.w[k], ts.accept[k], ts.valid[k],
            tx[None, :], ty[:, None])
        np.testing.assert_array_equal(np.asarray(jcov), tcov.numpy())
        np.testing.assert_array_equal(np.asarray(jdep), tdep.numpy())
        jb, jw = jgeometry.fragment_barycentrics(
            js.e[k], jx[None, :], jy[:, None], js.w[k])
        tb, tw = geometry.fragment_barycentrics(
            ts.e[k], tx[None, :], ty[:, None], ts.w[k])
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        ji = jgeometry.interpolate_attributes(
            js.e[k], jx[None, :], jy[:, None], jnp.asarray(colors[k]))
        ti = geometry.interpolate_attributes(
            ts.e[k], tx[None, :], ty[:, None], torch.as_tensor(colors[k]))
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_gather_corners_batched_and_unbatched():
    v, f = _soup(5)
    got = geometry.gather_corners(torch.as_tensor(v), torch.as_tensor(f))
    np.testing.assert_array_equal(
        got.numpy(), np.stack([v[b][f[b]] for b in range(v.shape[0])]))
    single = geometry.gather_corners(torch.as_tensor(v[0]),
                                     torch.as_tensor(f[0]))
    np.testing.assert_array_equal(single.numpy(), v[0][f[0]])
