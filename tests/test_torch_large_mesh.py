"""Large meshes and the per-tile face cap in the port
(tests/test_large_mesh.py's checks, and the facts chip_smoke.py's scale
phase relies on).

The dense and "pallas" backends and the mxu gradient keep at most
DIRT_TPU_TORCH_TILE_FACE_CAP faces a tile (band), as dirt_tpu keeps
DIRT_TPU_TILE_FACE_CAP; the tests set both variables.  On scattered grids
of small triangles:

  * a cap above every tile's live count changes nothing;
  * at 1,024 faces under a cap of 384 the list backends' winner maps equal
    the port's reference backend's, dirt_tpu's reference's and the native
    oracle's, and the mxu gradient stays within 3e-6 of the plain scatter
    gradient and of dirt_tpu's;
  * the block-binned backend sweeps the zig-zag draw order exactly;
  * a cap that truncates drops the same hits as dirt_tpu's dense backend
    where the tile shapes are set equal.

Last, the scale phase's largest configuration (bench.py's cylinder at
65,536 faces on a 512^2 image, image 0 of chip_smoke.bench_scene(4, 512,
8192)) is packed on the CPU: the block-binned schedule drops nothing,
the dense one at the default cap of 8,192 drops 75,081 hits.
"""

import pathlib
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_dense as jforward_dense
from dirt_tpu.utils import oracle as joracle
from dirt_tpu_torch.ops import (backward, dispatch, forward_blocks,
                                forward_dense, grad_mxu)
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


def _set_cap(monkeypatch, cap):
    monkeypatch.setenv("DIRT_TPU_TILE_FACE_CAP", str(cap))
    monkeypatch.setenv("DIRT_TPU_TORCH_TILE_FACE_CAP", str(cap))


def _tri_grid(n_side, size, rng):
    """n_side^2 small triangles scattered over the screen (the scene of
    tests/test_large_mesh.py)."""
    n = n_side * n_side
    gx, gy = np.meshgrid(np.linspace(-0.95, 0.8, n_side),
                         np.linspace(-0.95, 0.8, n_side))
    centres = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
    centres += rng.uniform(-0.01, 0.01, centres.shape).astype(np.float32)
    tri = np.stack([centres, centres + [size, 0.], centres + [0., size]],
                   axis=1)
    depth = rng.uniform(-0.5, 0.5, size=(n, 1, 1)).astype(np.float32)
    v = np.concatenate([
        tri, np.broadcast_to(depth, (n, 3, 1)),
        np.ones((n, 3, 1), np.float32)], axis=-1).reshape(1, n * 3, 4)
    v = v.astype(np.float32)
    f = np.arange(n * 3, dtype=np.int32).reshape(1, n, 3)
    return v, f


def _grid_scene(seed, n_side, size, height, width, background="random"):
    rng = np.random.RandomState(seed)
    v, f = _tri_grid(n_side, size, rng)
    c = rng.uniform(size=(1, v.shape[1], 3)).astype(np.float32)
    bg = (np.zeros((1, height, width, 3), np.float32) if background == "zero"
          else rng.uniform(size=(1, height, width, 3)).astype(np.float32))
    return rng, (bg, v, c, f)


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_cap_inactive_matches_uncapped(monkeypatch, backend):
    # A cap of 128 faces: above every 16x16 tile's live count, below the
    # 144 faces, so the capped packing runs.
    _, scene = _grid_scene(0, 12, 0.1, 64, 128, background="zero")
    args = [torch.tensor(a) for a in scene]
    base, aux_base = dispatch.forward_batch(*args, backend=backend)
    _set_cap(monkeypatch, 128)
    capped, aux_capped = dispatch.forward_batch(*args, backend=backend)
    assert torch.equal(aux_base.face_index, aux_capped.face_index)
    assert torch.equal(base, capped)
    assert int(aux_capped.dropped.max()) == 0
    _, want_index = oracle.rasterise(*(a[0] for a in scene))
    np.testing.assert_array_equal(aux_capped.face_index[0].numpy(),
                                  want_index)


@pytest.fixture(scope="module")
def thousand():
    """1,024 faces on a 128 x 256 image (seed 1), with the port's
    reference forward, dirt_tpu's reference forward, the native oracle's
    winner map and an upstream cotangent."""
    rng, scene = _grid_scene(1, 32, 0.05, 128, 256)
    ref = dispatch.forward_batch(*(torch.tensor(a) for a in scene),
                                 backend="reference")
    jref = jdispatch.forward_batch(*scene, backend="reference")
    _, want_index = joracle.rasterise(*(a[0] for a in scene))
    gp = rng.randn(*scene[0].shape).astype(np.float32)
    return scene, ref, jref, want_index, gp


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_thousands_of_faces_parity_under_cap(monkeypatch, thousand,
                                             backend):
    _set_cap(monkeypatch, 384)
    scene, (ref, aux_r), (jref, jaux_r), want_index, _ = thousand
    px, aux = dispatch.forward_batch(*(torch.tensor(a) for a in scene),
                                     backend=backend)
    assert int(aux.dropped.max()) == 0
    assert torch.equal(aux.face_index, aux_r.face_index)
    np.testing.assert_array_equal(aux.face_index.numpy(),
                                  np.asarray(jaux_r.face_index))
    np.testing.assert_array_equal(aux.face_index[0].numpy(), want_index)
    torch.testing.assert_close(px, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(px.numpy(), np.asarray(jref), atol=1e-4,
                               rtol=1e-5)


def test_mxu_gradient_under_cap(monkeypatch, thousand):
    _set_cap(monkeypatch, 384)
    scene, (ref, aux_r), (jref, jaux_r), _, gp = thousand
    v, f = torch.tensor(scene[1]), torch.tensor(scene[3])
    g_xla = backward.rasterise_grad_batch(v, f, ref, torch.tensor(gp), aux_r,
                                          implementation="xla")
    g_mxu = grad_mxu.rasterise_grad_batch(v, f, ref, torch.tensor(gp), aux_r)
    want = jbackward.rasterise_grad_batch(
        jnp.asarray(scene[1]), jnp.asarray(scene[3]), jref, jnp.asarray(gp),
        jaux_r, implementation="xla")
    for name in ("grad_vertices", "grad_vertex_colors"):
        got = getattr(g_mxu, name).numpy()
        _close(got, getattr(g_xla, name).numpy(), 3e-6)
        _close(got, np.asarray(getattr(want, name)), 3e-6)
    assert float(g_mxu.grad_vertices.abs().sum()) > 0


def test_blocks_backend_scattered_mesh():
    # Draw order zig-zags over the screen (low spatial coherence): the
    # stressing shape for block-granularity binning.
    rng, scene = _grid_scene(5, 32, 0.05, 64, 128)
    args = [torch.tensor(a) for a in scene]
    px_b, aux_b = dispatch.forward_batch(*args, backend="blocks")
    px_r, aux_r = dispatch.forward_batch(*args, backend="reference")
    assert forward_blocks.CHUNK == 32
    assert torch.equal(aux_b.face_index, aux_r.face_index)
    torch.testing.assert_close(px_b, px_r, atol=1e-4, rtol=1e-5)
    _, jaux = jdispatch.forward_batch(*scene, backend="reference")
    np.testing.assert_array_equal(aux_b.face_index.numpy(),
                                  np.asarray(jaux.face_index))
    ones = torch.ones_like(px_b)
    g_b = backward.rasterise_grad_batch(args[1], args[3], px_b, ones, aux_b,
                                        implementation="blocks")
    g_x = backward.rasterise_grad_batch(args[1], args[3], px_b, ones, aux_b,
                                        implementation="xla")
    for name in ("grad_vertices", "grad_vertex_colors", "grad_background"):
        _close(getattr(g_b, name).numpy(), getattr(g_x, name).numpy(), 1e-5)


@pytest.mark.parametrize("cap", [16, 48])
def test_capped_drops_match_dirt_tpu(monkeypatch, cap):
    # Caps below the busiest tiles' counts: both packages keep the
    # earliest-drawn `cap` faces of each 16x256 tile (dirt_tpu's dense
    # tile at this width, set on the port's side).
    _set_cap(monkeypatch, cap)
    _, scene = _grid_scene(1, 32, 0.05, 128, 256)
    want_px, want_aux = jforward_dense.rasterise_batch(*scene,
                                                       interpret=True)
    th, tw = jforward_dense.tile_shape(128, 256)
    got_px, got_aux = forward_dense.rasterise_batch(
        *(torch.tensor(a) for a in scene), tile_h=th, tile_w=tw)
    assert int(got_aux.dropped.max()) > 0
    np.testing.assert_array_equal(got_aux.dropped.numpy(),
                                  np.asarray(want_aux.dropped))
    np.testing.assert_array_equal(got_aux.face_index.numpy(),
                                  np.asarray(want_aux.face_index))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px),
                               atol=1e-4, rtol=1e-5)


def test_large_mesh_configuration_pack(monkeypatch):
    # chip_smoke's 4 x 512^2 x 65,536-face scale row, image 0, packed as
    # its steps pack it: the block-binned schedule fits its slot budget,
    # the dense lists overflow the default cap (the scale phase checks
    # dense uncapped and prints these drops).
    monkeypatch.delenv("DIRT_TPU_TORCH_TILE_FACE_CAP", raising=False)
    _, clip, colors, faces, _ = chip_smoke.bench_scene(4, 512, 8192, "cpu")
    assert faces.shape[1] == 65536
    image = (clip[:1], colors[:1], faces[:1], 512, 512)
    *_, counts, _, dropped = forward_blocks.pack(
        *image, forward_blocks.TILE_H, forward_blocks.TILE_W,
        forward_blocks.CHUNK)
    assert dropped.tolist() == [0]
    assert int(counts.max()) > 600          # the busiest run's visits
    *_, list_counts, dense_dropped = forward_dense.pack(
        *image, forward_dense.TILE_H, forward_dense.TILE_W,
        forward_dense.CHUNK)
    assert dense_dropped.tolist() == [75081]
    assert int(list_counts.max()) == 8192
