"""dirt_tpu_torch.matrices against dirt_tpu.matrices, function by function.

Mirrors tests/test_matrices.py's twelve checks: each builds the same
seeded (numpy) inputs for both packages, holds the port's matrix against
dirt_tpu's and then checks the property dirt_tpu's test checks.  Entries
built from +, -, x and / of the inputs agree exactly; rodrigues' cos and
sin, and compose's matrix products (XLA's CPU dot may contract FMAs,
torch's does not), within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu import matrices as jmatrices
from dirt_tpu_torch import matrices


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TRIG_TOL = 1e-6


def _both(name, *args, **kwargs):
    """(port's result as numpy, dirt_tpu's) of matrices.`name`."""
    port = getattr(matrices, name)(*args, device="cpu", **kwargs)
    return port.numpy(), np.asarray(getattr(jmatrices, name)(*args, **kwargs))


def _row(v):
    return np.asarray(v, np.float32)


def test_rodrigues_identity_at_zero():
    got, want = _both("rodrigues", np.zeros(3, np.float32))
    np.testing.assert_allclose(got, want, atol=TRIG_TOL)
    np.testing.assert_allclose(got, np.eye(4), atol=1e-6)


def test_rodrigues_quarter_turn_about_z():
    got, want = _both("rodrigues", _row([0., 0., np.pi / 2]),
                      three_by_three=True)
    np.testing.assert_allclose(got, want, atol=TRIG_TOL)
    np.testing.assert_allclose(_row([1., 0., 0.]) @ got, [0., -1., 0.],
                               atol=1e-6)


def test_rodrigues_orthonormal():
    vecs = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    got, want = _both("rodrigues", vecs, three_by_three=True)
    np.testing.assert_allclose(got, want, atol=TRIG_TOL)
    prod = np.einsum("bij,bkj->bik", got, got)
    np.testing.assert_allclose(prod, np.tile(np.eye(3), (5, 1, 1)),
                               atol=1e-5)


def test_rodrigues_gradient_finite_at_zero():
    v = torch.zeros(3, requires_grad=True)
    matrices.rodrigues(v).sum().backward()
    want = np.asarray(jax.grad(lambda x: jnp.sum(jmatrices.rodrigues(x)))(
        jnp.zeros(3)))
    assert np.isfinite(v.grad.numpy()).all()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_translation_applies_to_points():
    got, want = _both("translation", _row([1., 2., 3.]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_row([10., 20., 30., 1.]) @ got,
                               [11., 22., 33., 1.], atol=1e-6)


def test_scale():
    got, want = _both("scale", _row([2., 3., 4.]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_row([1., 1., 1., 1.]) @ got,
                               [2., 3., 4., 1.], atol=1e-6)


def test_scale_batched():
    factors = np.random.RandomState(1).uniform(0.5, 2., (7, 3)).astype(
        np.float32)
    got, want = _both("scale", factors)
    assert got.shape == (7, 4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], np.diag([*factors[3], 1.]))


def test_perspective_projection_near_far_planes():
    near, far = 0.1, 20.
    got, want = _both("perspective_projection", near, far, 0.1, 1.)
    np.testing.assert_array_equal(got, want)
    p_near = _row([0., 0., -near, 1.]) @ got
    assert np.isclose(p_near[2] / p_near[3], -1., atol=1e-5)
    p_far = _row([0., 0., -far, 1.]) @ got
    assert np.isclose(p_far[2] / p_far[3], 1., atol=1e-5)
    assert np.isclose(p_near[3], near, atol=1e-6)


def test_perspective_projection_frustum_edge():
    got, want = _both("perspective_projection", 0.1, 20., 0.2, 0.5)
    np.testing.assert_array_equal(got, want)
    p = _row([0.2, 0., -0.1, 1.]) @ got
    assert np.isclose(p[0] / p[3], 1., atol=1e-5)
    p = _row([0., 0.1, -0.1, 1.]) @ got
    assert np.isclose(p[1] / p[3], 1., atol=1e-5)


def test_pad_3x3_to_4x4():
    m = np.random.RandomState(2).randn(2, 3, 3).astype(np.float32)
    got, want = _both("pad_3x3_to_4x4", m)
    np.testing.assert_array_equal(got, want)
    expected = np.zeros((2, 4, 4), np.float32)
    expected[:, :3, :3] = m
    expected[:, 3, 3] = 1.
    np.testing.assert_array_equal(got, expected)


def test_compose_order():
    rng = np.random.RandomState(3)
    t = rng.randn(3).astype(np.float32)
    s = rng.uniform(0.5, 2., 3).astype(np.float32)
    r = rng.randn(3).astype(np.float32)
    args = lambda m: (m.translation(t, **kw(m)), m.scale(s, **kw(m)),
                      m.rodrigues(r, **kw(m)))
    kw = lambda m: {"device": "cpu"} if m is matrices else {}
    got = matrices.compose(*args(matrices)).numpy()
    want = np.asarray(jmatrices.compose(*args(jmatrices)))
    np.testing.assert_allclose(got, want, atol=TRIG_TOL)
    # compose(A, B) applies A first: translate then scale.
    ts = matrices.compose(matrices.translation([1., 0., 0.], device="cpu"),
                          matrices.scale([2., 2., 2.], device="cpu")).numpy()
    np.testing.assert_allclose((_row([0., 0., 0., 1.]) @ ts)[:3],
                               [2., 0., 0.], atol=1e-6)
    st = matrices.compose(matrices.scale([2., 2., 2.], device="cpu"),
                          matrices.translation([1., 0., 0.], device="cpu"))
    np.testing.assert_allclose((_row([1., 0., 0., 1.]) @ st.numpy())[:3],
                               [3., 0., 0.], atol=1e-6)


def test_compose_empty_is_identity():
    got = matrices.compose(device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jmatrices.compose()))
    np.testing.assert_array_equal(got, np.eye(4))
