"""The "pallas" backend of dirt_tpu_torch against dirt_tpu's, on the CPU.

Both packages read the same seeded numpy scenes.  The port's pallas
forward (kernel K8's plain version: the literal coverage tree over each
tile's exact face list, then per-pixel shading of the winner) is held
against dirt_tpu's pallas forward in Pallas interpret mode: winner maps,
vertex ids and dropped counts equal; pixels, barycentrics and clip w
within atol=1e-4, rtol=1e-5 (XLA may contract products in interpret
mode; eager PyTorch never does).  Against the port's own dense backend
(same lists, COVER_FAST sweep + finalize) every output is equal bit for
bit.  The square scene is pixel-exact, as dirt_tpu's tests/test_square.py
requires of every backend.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
from dirt_tpu.ops import forward_pallas as jforward_pallas
import dirt_tpu_torch
from dirt_tpu_torch.ops import dispatch, forward_dense, forward_pallas
from dirt_tpu_torch.utils import convert


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
AUX_FIELDS = ("face_index", "indices", "barycentric", "clip_w", "dropped")


def soup(seed, batch=2, nv=60, nf=120, h=64, w=128, crossing=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    gp = rng.randn(batch, h, w, 3).astype(np.float32)
    return dict(background=bg, vertices=v, colors=c, faces=f, grad=gp)


SCENES = {
    "soup": lambda: soup(0),
    "crossing": lambda: soup(1, crossing=True),
    "unaligned48x80": lambda: soup(3, nf=90, h=48, w=80),
}


def _args(s):
    return s["background"], s["vertices"], s["colors"], s["faces"]


def _torch(s):
    t = convert.scene_to_torch(s, "cpu")
    return t["background"], t["vertices"], t["colors"], t["faces"]


def _assert_forward_close(want, got):
    want_px, want_aux = want
    got_px, got_aux = got
    got_aux = convert.aux_to_numpy(got_aux)
    for name in ("face_index", "indices", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(got_aux, name), err_msg=name)
    for name, a, b in (("pixels", want_px, got_px.numpy()),
                       ("barycentric", want_aux.barycentric,
                        got_aux.barycentric),
                       ("clip_w", want_aux.clip_w, got_aux.clip_w)):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-4, rtol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_pallas():
    """dirt_tpu's pallas forward (interpret mode) on every scene."""
    return {name: jforward_pallas.rasterise_batch(*_args(make()),
                                                  interpret=True)
            for name, make in SCENES.items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pallas_forward_matches_jax(jax_pallas, scene):
    got = dispatch.forward_batch(*_torch(SCENES[scene]()), "pallas")
    _assert_forward_close(jax_pallas[scene], got)
    assert int(got[1].dropped.max()) == 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pallas_forward_equals_dense_bitwise(scene):
    args = _torch(SCENES[scene]())
    px, aux = dispatch.forward_batch(*args, "pallas")
    dense_px, dense_aux = dispatch.forward_batch(*args, "dense")
    assert torch.equal(px, dense_px)
    for name in AUX_FIELDS:
        assert torch.equal(getattr(aux, name), getattr(dense_aux, name)), name
    assert int((aux.face_index >= 0).sum()) > 0


def test_pallas_cap_matches_jax(monkeypatch):
    # A cap of 40 faces in 32-face chunks keeps 64 slots per tile in both
    # packages (dirt_tpu's chunk shrunk from 512); tiles overlapped by more
    # faces drop the same, latest-drawn ones.
    s = soup(5, nf=120, h=32, w=128)
    monkeypatch.setattr(jforward_pallas, "CHUNK", 32)
    monkeypatch.setenv("DIRT_TPU_TILE_FACE_CAP", "40")
    monkeypatch.setenv("DIRT_TPU_TORCH_TILE_FACE_CAP", "40")
    want = jforward_pallas.rasterise_batch(*_args(s), interpret=True)
    got = forward_pallas.rasterise_batch(*_torch(s), tile_h=32, tile_w=128,
                                         chunk=32)
    assert int(np.asarray(want[1].dropped).sum()) > 0
    _assert_forward_close(want, got)


def test_pallas_raster_tile_shapes_agree():
    # The plain kernel at dirt_tpu's 32x128 tile and at the GPU's 16x16
    # tile, with chunks of 64 and of 7 slots: the same outputs.
    args = _torch(SCENES["unaligned48x80"]())
    outs = [forward_pallas.rasterise_batch(*args, tile_h=th, tile_w=tw,
                                           chunk=chunk)
            for th, tw, chunk in ((16, 16, 64), (32, 128, 64), (16, 16, 7))]
    for px, aux in outs[1:]:
        assert torch.equal(px, outs[0][0])
        for name in AUX_FIELDS:
            assert torch.equal(getattr(aux, name),
                               getattr(outs[0][1], name)), name


CANVAS = 128
CENTRE_X, CENTRE_Y, SQUARE = 32, 64, 16


def test_square_pixels_exact():
    # tests/test_square.py's scene and analytic coverage, pixel-exact.
    xs, ys = np.meshgrid(np.arange(CANVAS), np.arange(CANVAS))
    inside = ((np.abs(xs + 0.5 - CENTRE_X) <= SQUARE / 2)
              & (np.abs(ys + 0.5 - CENTRE_Y) <= SQUARE / 2))
    square = (np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
              * SQUARE - SQUARE / 2. + [CENTRE_X, CENTRE_Y])
    square = square * 2. / [CANVAS, CANVAS] - 1.
    vertices = np.concatenate([square, np.zeros([4, 1], np.float32),
                               np.ones([4, 1], np.float32)], axis=1)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    pixels = dirt_tpu_torch.rasterise(
        np.zeros([CANVAS, CANVAS, 1], np.float32), vertices,
        np.ones([4, 1], np.float32), faces, height=CANVAS, width=CANVAS,
        channels=1, backend="pallas", device="cpu")[..., 0]
    assert int((pixels.numpy() != inside.astype(np.float32)).sum()) == 0


def test_zero_faces_match_jax():
    s = soup(6, nf=1, h=16, w=24)
    s["faces"] = s["faces"][:, :0]
    want_px, want_aux = jforward_pallas.rasterise_batch(*_args(s),
                                                        interpret=True)
    px, aux = dispatch.forward_batch(*_torch(s), "pallas")
    np.testing.assert_array_equal(np.asarray(want_px), px.numpy())
    for name in AUX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(aux, name).numpy(), err_msg=name)


def test_backend_pairs_with_the_blocks_gradient(monkeypatch):
    monkeypatch.delenv("DIRT_TPU_TORCH_GRAD_BACKEND", raising=False)
    assert "pallas" in dispatch.BACKENDS
    assert dispatch.GRAD_FOR_BACKEND["pallas"] == "blocks"
    assert dispatch.grad_for_backend("pallas") == "blocks"
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "mxu")
    assert dispatch.grad_for_backend("pallas") == "mxu"
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "auto")
    assert dispatch.grad_for_backend("dense") == "dense"


def _close(a, b, name):
    a = np.asarray(a)
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(np.asarray(b) / scale, a / scale, atol=TOL,
                               err_msg=name)


def test_pallas_step_matches_jax():
    # The whole differentiable step on the pallas backend in both packages:
    # dirt_tpu's pallas forward (interpret mode) with its CPU gradient
    # ("xla"), the port's with its pairing (the blocks gradient's plain
    # versions here).
    s = soup(4, nv=48, nf=80, h=40, w=64)
    weights = s["grad"]

    def loss(c, col, bg):
        px = dirt_tpu.rasterise_batch(bg, c, col, s["faces"],
                                      backend="pallas")
        return jnp.sum(px * weights), px
    (_, want_px), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(s["vertices"]), jnp.asarray(s["colors"]),
        jnp.asarray(s["background"]))
    want_v, want_c, want_bg = (np.asarray(g) for g in grads)

    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("background", "vertices", "colors")]
    px = dirt_tpu_torch.rasterise_batch(*leaves, s["faces"],
                                        backend="pallas")
    (px * torch.as_tensor(weights)).sum().backward()
    np.testing.assert_allclose(px.detach().numpy(), np.asarray(want_px),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(leaves[0].grad.numpy(), want_bg)
    _close(want_v, leaves[1].grad.numpy(), "vertices")
    _close(want_c, leaves[2].grad.numpy(), "colours")
    assert np.abs(leaves[1].grad.numpy()).max() > 0


def test_pallas_raster_on_cpu_runs_the_plain_version():
    s = SCENES["soup"]()
    bg, v, c, f = _torch(s)
    h, w = bg.shape[1:3]
    table, face_ids, counts, _ = forward_dense.pack(v, c, f, h, w, 16, 16, 64)
    args = (table, face_ids, counts, bg, w // 16, (h // 16) * (w // 16), 16,
            16, 64)
    got = forward_pallas.pallas_raster(*args)
    want = forward_pallas.pallas_raster_plain(*args)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert got[0].shape == bg.shape and got[1].dtype == torch.int32
