"""The two switches that change which blocks the block-binned schedules
visit, forward_blocks.SPATIAL (the Morton sort of the table rows) and
forward_blocks.EDGE_CULL (the half-plane refinement of the hit test),
against dirt_tpu with the same settings, on the CPU.

The port's counterparts of tests/test_spatial_sort.py and
tests/test_edge_cull.py: neither switch may change the forward output
(pixels and every aux field bitwise), the cull may not change the
gradients (bitwise: culled visits add exact zeros), and each must cut the
visits on the scene built to show it.  With a switch off, the port
matches dirt_tpu with it off: winner map, vertex ids and dropped bitwise,
pixels within atol=1e-4, rtol=1e-5, gradients within 3e-6 (normalised),
as tests/test_torch_forward.py and tests/test_torch_backward.py compare.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_blocks as jforward_blocks
from dirt_tpu.ops import grad_blocks as jgrad_blocks
from dirt_tpu_torch.ops import (backward, dispatch, forward_blocks,
                                forward_pallas, grad_blocks)
from dirt_tpu_torch.ops.reference import RasterAux
from dirt_tpu_torch.utils import convert, meshes


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


JAX_TILE = dict(tile_h=4, tile_w=128, chunk=64)
JAX_GRAD_TILE = dict(tile_h=8, tile_w=128, chunk=128)
TOL = 3e-6


def scattered_scene(num_faces=256, height=64, width=128, seed=0):
    """tests/test_spatial_sort.py's scene: small right triangles scattered
    over the image in a random draw order."""
    rng = np.random.RandomState(seed)
    grid = int(np.ceil(np.sqrt(num_faces)))
    cx = (np.arange(num_faces) % grid + 0.5) / grid * 2.0 - 1.0
    cy = (np.arange(num_faces) // grid + 0.5) / grid * 2.0 - 1.0
    size = 0.8 / grid
    xy = np.stack([np.stack([cx - size, cy - size], 1),
                   np.stack([cx + size, cy - size], 1),
                   np.stack([cx - size, cy + size], 1)], 1).reshape(-1, 2)
    z = rng.uniform(-0.5, 0.5, size=(xy.shape[0], 1)).astype(np.float32)
    v = np.concatenate([xy.astype(np.float32), z, np.ones_like(z)], 1)
    f = np.arange(num_faces * 3, dtype=np.int32).reshape(-1, 3)
    f = f[rng.permutation(num_faces)]
    c = rng.uniform(size=(v.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(height, width, 3)).astype(np.float32)
    return bg[None], v[None], c[None], f[None]


def diagonal_strips(n=24, width=256):
    """tests/test_edge_cull.py's long thin diagonal triangles."""
    rng = np.random.RandomState(2)
    t = np.linspace(-0.9, 0.1, n, dtype=np.float32)
    zero = np.zeros_like(t)
    v = np.concatenate([np.stack([t, t, zero], -1),
                        np.stack([t + 0.8, t + 0.82, zero], -1),
                        np.stack([t + 0.02, t, zero], -1)], 0)
    v = np.concatenate([v, np.ones((v.shape[0], 1), np.float32)], 1)
    f = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                 1).astype(np.int32)
    c = rng.uniform(size=(v.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(64, width, 3)).astype(np.float32)
    return bg[None], v[None], c[None], f[None]


def squares():
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, size=0.45, back_size=0.4)
    rng = np.random.RandomState(3)
    return (rng.uniform(size=(1, 48, 128, 3)).astype(np.float32),
            verts[None], rng.uniform(size=(1, 8, 3)).astype(np.float32),
            faces[None])


def soup():
    rng = np.random.RandomState(7)
    v = rng.randn(1, 60, 4).astype(np.float32)
    v[..., 3] = np.abs(v[..., 3]) + 0.5
    f = rng.randint(0, 60, size=(1, 45, 3)).astype(np.int32)
    c = rng.uniform(size=(1, 60, 3)).astype(np.float32)
    return rng.uniform(size=(1, 64, 128, 3)).astype(np.float32), v, c, f


def occlusion():
    """tests/test_edge_cull.py's gradient scene: two overlapping squares."""
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, size=0.8, back_size=0.9)
    rng = np.random.RandomState(5)
    v = np.stack([verts, verts + [0.04, 0., 0., 0.]]).astype(np.float32)
    f = np.stack([faces, faces])
    c = rng.uniform(size=(2, 8, 3)).astype(np.float32)
    bg = rng.uniform(size=(2, 64, 128, 3)).astype(np.float32)
    gp = rng.randn(2, 64, 128, 3).astype(np.float32)
    return bg, v, c, f, gp


def _torch(args):
    return [torch.as_tensor(a) for a in args]


def _same(a, b):
    assert torch.equal(a[0], b[0])
    for field in a[1]._fields:
        assert torch.equal(getattr(a[1], field), getattr(b[1], field)), field


def _assert_forward_close(want, got):
    want_px, want_aux = want
    got_px, got_aux = got
    got_aux = convert.aux_to_numpy(got_aux)
    for name in ("face_index", "indices", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(got_aux, name), err_msg=name)
    np.testing.assert_allclose(np.asarray(want_px), got_px.numpy(),
                               atol=1e-4, rtol=1e-5)


def _assert_grads_close(want, got):
    np.testing.assert_array_equal(np.asarray(want.grad_background),
                                  got.grad_background.numpy())
    for name in ("grad_vertices", "grad_vertex_colors"):
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=TOL,
                                   err_msg=name)


def _jax_with(module, name, value, run):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        return run()
    finally:
        setattr(module, name, saved)


# -- SPATIAL ---------------------------------------------------------------

@pytest.mark.parametrize("shape", ["gpu", "jax"])
def test_forward_bitwise_invariant_under_spatial_sort(monkeypatch, shape):
    kw = JAX_TILE if shape == "jax" else {}
    args = _torch(scattered_scene())
    sorted_ = forward_blocks.rasterise_batch(*args, **kw)
    monkeypatch.setattr(forward_blocks, "SPATIAL", False)
    _same(sorted_, forward_blocks.rasterise_batch(*args, **kw))


def test_forward_without_spatial_sort_matches_jax(monkeypatch):
    scene = scattered_scene(seed=3)
    want = _jax_with(jforward_blocks, "SPATIAL", False,
                     lambda: jdispatch.forward_batch(*scene, "blocks"))
    monkeypatch.setattr(forward_blocks, "SPATIAL", False)
    got = forward_blocks.rasterise_batch(*_torch(scene), **JAX_TILE)
    _assert_forward_close(want, got)
    _, ref = dispatch.forward_batch(*_torch(scene), "reference")
    assert torch.equal(got[1].face_index, ref.face_index)


def test_gradients_without_spatial_sort_match_jax(monkeypatch):
    bg, v, c, f = scattered_scene(num_faces=192, seed=7)
    px, aux = jdispatch.forward_batch(bg, v, c, f, "reference")
    gp = np.random.RandomState(11).uniform(size=px.shape).astype(np.float32)
    want = _jax_with(jforward_blocks, "SPATIAL", False,
                     lambda: jgrad_blocks.rasterise_grad_batch(
                         v, f, px, jnp.asarray(gp), aux, interpret=True))
    monkeypatch.setattr(forward_blocks, "SPATIAL", False)
    t = lambda a: torch.as_tensor(np.array(a))
    taux = RasterAux(*(t(x) for x in aux))
    got = grad_blocks.rasterise_grad_batch(t(v), t(f), t(px), t(gp), taux,
                                           **JAX_GRAD_TILE)
    _assert_grads_close(want, got)
    # Unsorted, the table rows are the faces in order.
    row_face = grad_blocks.pack(t(v), t(f), 64, 128, 16, 16, 32)[4]
    assert torch.equal(row_face[0], torch.arange(192, dtype=torch.int32))
    monkeypatch.setattr(forward_blocks, "SPATIAL", True)
    sorted_ = grad_blocks.rasterise_grad_batch(t(v), t(f), t(px), t(gp),
                                               taux, **JAX_GRAD_TILE)
    _assert_grads_close(want, sorted_)


@pytest.mark.parametrize("chunk,tile_h", [(64, 4), (32, 8), (32, 16)])
def test_spatial_sort_reduces_block_visits(chunk, tile_h):
    bg, v, c, f = _torch(scattered_scene())
    height, width = bg.shape[1:3]
    num_blocks = -(-f.shape[1] // chunk)
    tile_w = 128 if tile_h < 16 else 16
    tiles = (-(-height // tile_h), -(-width // tile_w), tile_h, tile_w)
    face_data = forward_pallas._face_table(
        v, c, f, height, width, num_blocks * chunk - f.shape[1])
    raw = forward_blocks.hit_matrix(face_data, (20, 21, 22, 23), num_blocks,
                                    chunk, *tiles)
    order = forward_blocks.spatial_order(face_data, (20, 21, 22, 23), tile_h,
                                         tile_w)
    srt = forward_blocks.hit_matrix(
        torch.take_along_dim(face_data, order[..., None].long(), dim=1),
        (20, 21, 22, 23), num_blocks, chunk, *tiles)
    assert int(srt.sum()) < int(raw.sum()) / 2, (int(raw.sum()),
                                                 int(srt.sum()))


# -- EDGE_CULL -------------------------------------------------------------

def test_cull_reduces_visits(monkeypatch):
    # Per-face hits (chunk 1) of the diagonal strips: the cull keeps only
    # the tile columns each face crosses in each row band.
    bg, v, c, f = _torch(diagonal_strips())
    height, width = bg.shape[1:3]
    fd = forward_pallas._face_table(v, c, f, height, width, 0)
    kw = dict(num_blocks=f.shape[1], chunk=1, tiles_y=height // 8,
              tiles_x=width // 128, tile_h=8, tile_w=128, edge_cols=0,
              height=height, width=width)
    monkeypatch.setattr(forward_blocks, "EDGE_CULL", False)
    n_off = int(forward_blocks.hit_matrix(fd, (20, 21, 22, 23), **kw).sum())
    monkeypatch.setattr(forward_blocks, "EDGE_CULL", True)
    n_on = int(forward_blocks.hit_matrix(fd, (20, 21, 22, 23), **kw).sum())
    assert n_on < 0.75 * n_off, (n_on, n_off)


@pytest.mark.parametrize("scene", ["strips", "squares", "soup"])
@pytest.mark.parametrize("shape", ["gpu", "jax"])
def test_forward_identical_with_cull(monkeypatch, scene, shape):
    make = {"strips": diagonal_strips, "squares": squares, "soup": soup}
    args = _torch(make[scene]())
    kw = JAX_TILE if shape == "jax" else {}
    culled = forward_blocks.rasterise_batch(*args, **kw)
    monkeypatch.setattr(forward_blocks, "EDGE_CULL", False)
    _same(culled, forward_blocks.rasterise_batch(*args, **kw))
    _, ref = dispatch.forward_batch(*args, "reference")
    assert torch.equal(culled[1].face_index, ref.face_index)


def test_forward_without_cull_matches_jax(monkeypatch):
    scene = diagonal_strips()
    want = _jax_with(jforward_blocks, "EDGE_CULL", False,
                     lambda: jdispatch.forward_batch(*scene, "blocks"))
    monkeypatch.setattr(forward_blocks, "EDGE_CULL", False)
    _assert_forward_close(want, forward_blocks.rasterise_batch(
        *_torch(scene), **JAX_TILE))


def test_gradients_identical_with_cull(monkeypatch):
    bg, v, c, f, gp = occlusion()
    px, aux = jdispatch.forward_batch(bg, v, c, f, "reference")
    t = lambda a: torch.as_tensor(np.array(a))
    args = (t(v), t(f), t(px), t(gp), RasterAux(*(t(x) for x in aux)))
    culled = backward.rasterise_grad_batch(*args, implementation="blocks")
    monkeypatch.setattr(forward_blocks, "EDGE_CULL", False)
    unculled = backward.rasterise_grad_batch(*args, implementation="blocks")
    for name in culled._fields:
        assert torch.equal(getattr(culled, name), getattr(unculled, name)), (
            name)
    want = _jax_with(jforward_blocks, "EDGE_CULL", False,
                     lambda: jbackward.rasterise_grad_batch(
                         v, f, px, jnp.asarray(gp), aux,
                         implementation="blocks"))
    got = grad_blocks.rasterise_grad_batch(*args, **JAX_GRAD_TILE)
    _assert_grads_close(want, got)
