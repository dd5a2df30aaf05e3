"""The "dense" backend of dirt_tpu_torch against dirt_tpu's, on the CPU.

Both packages read the same seeded numpy scenes.  The per-tile packings
(_pack_faces, _pack_grad_faces) must equal dirt_tpu's bit for bit at its
tile shapes: the port keeps row indices into one face table where
dirt_tpu copies the rows per tile, so the gathered rows are compared.
On the camera-crossing scene the port clips the bboxes of faces with a
corner at w <= 0 where dirt_tpu gives them the screen: there its table
equals dirt_tpu's on every other face and column, those bboxes hold the
pixels their faces cover (tests/clip_bbox.py), and its packing equals
dirt_tpu's packing of the port's table.
The dense forward (kernel K7's plain version) is held against dirt_tpu's
dense forward in Pallas interpret mode: winner maps, vertex ids and
dropped counts equal, pixels, barycentrics and clip w within atol=1e-4,
rtol=1e-5 (XLA may contract products in interpret mode; eager PyTorch
never does).  The dense gradient (kernel K9's plain version) is held
against dirt_tpu's within max |a - b| / max(max |a|, 1) <= 3e-6 (the
bound of tests/test_grad_kernels.py: the two sum in different orders),
with grad_background exactly equal.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_dense as jforward_dense
from dirt_tpu.ops import forward_pallas as jforward_pallas
from dirt_tpu.ops import grad_dense as jgrad_dense
from dirt_tpu.ops import grad_tables as jgrad_tables
import dirt_tpu_torch
from dirt_tpu_torch.ops import (backward, dispatch, forward_dense,
                                forward_pallas, grad_dense, grad_tables)
from dirt_tpu_torch.ops.reference import RasterAux
from dirt_tpu_torch.utils import convert

import clip_bbox


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


def _cdiv(a, b):
    return -(-a // b)


def _close(a, b, name):
    a = np.asarray(a)
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b / scale, a / scale, atol=TOL, err_msg=name)


# -- the per-tile packings --------------------------------------------------

@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pack_faces_matches_jax(scene, cut, monkeypatch):
    # cut: one 16-slot chunk per tile, fewer than the hits of most tiles.
    s = SCENES[scene]()
    batch, h, w, _ = s["background"].shape
    nf = s["faces"].shape[1]
    th, tw = jforward_dense.tile_shape(h, w)
    chunk = 16 if cut else jforward_dense.CHUNK
    nc = 1 if cut else _cdiv(nf, chunk)
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    _, v, c, f = _torch(s)
    face_data, face_ids, counts, dropped = forward_pallas._pack_faces(
        v, c, f, h, w, nc, ty, tx, chunk, th, tw)
    rows = torch.stack([face_data[b][face_ids[b].long()]
                        for b in range(batch)])
    crossing = clip_bbox.unbounded(v, f)
    if crossing.any():
        bbox = (20, 21, 22, 23)
        want_table = jax.vmap(functools.partial(
            jforward_pallas._face_table, height=h, width=w,
            pad_rows=face_data.shape[1] - nf))(
            s["vertices"], s["colors"], s["faces"])
        clip_bbox.assert_table_parity(face_data, want_table, bbox, v, f)
        clip_bbox.assert_contained(
            v, f, [face_data[:, :nf, col] for col in bbox], h, w,
            only=crossing)
    pack = functools.partial(
        jforward_pallas._pack_faces, height=h, width=w, num_chunks=nc,
        tiles_y=ty, tiles_x=tx, chunk=chunk, tile_h=th, tile_w=tw)
    images = (s["vertices"], s["colors"], s["faces"])
    if crossing.any():
        want_rows, want_counts, want_dropped = clip_bbox.packed_on(
            face_data, jforward_pallas, "_face_table", pack, *images,
            monkeypatch=monkeypatch)
    else:
        want_rows, want_counts, want_dropped = jax.vmap(pack)(*images)
    np.testing.assert_array_equal(
        np.asarray(want_rows).reshape(rows.shape), rows.numpy())
    np.testing.assert_array_equal(
        np.asarray(want_counts).reshape(batch, -1), counts.numpy())
    np.testing.assert_array_equal(np.asarray(want_dropped), dropped.numpy())
    assert (int(dropped.sum()) > 0) == cut


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("scene", ["soup", "crossing"])
def test_pack_grad_faces_matches_jax(scene, cut, monkeypatch):
    s = SCENES[scene]()
    batch, h, w, _ = s["background"].shape
    nf = s["faces"].shape[1]
    th, tw, chunk = 32, 128, 64
    if cut:
        th, tw, chunk = 16, 32, 8      # one 8-slot chunk: the cap cuts
    nc = 1 if cut else _cdiv(nf, chunk)
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    _, v, _, f = _torch(s)
    face_data, face_ids, counts, sorted_orig = grad_tables._pack_grad_faces(
        v, f, h, w, nc, ty, tx, chunk, th, tw)
    rows = torch.stack([face_data[b][face_ids[b].long()]
                        for b in range(batch)])
    crossing = clip_bbox.unbounded(v, f)
    if crossing.any():
        bbox = grad_tables._BBOX
        want_table = jax.vmap(functools.partial(
            jgrad_tables._grad_face_table, height=h, width=w,
            pad_rows=face_data.shape[1] - nf))(s["vertices"], s["faces"])
        clip_bbox.assert_table_parity(face_data, want_table, bbox, v, f)
        # Widened a pixel for the gradient's dilation.
        clip_bbox.assert_contained(
            v, f, [face_data[:, :nf, col] for col in bbox], h, w, dilate=1,
            only=crossing)
    pack = functools.partial(
        jgrad_tables._pack_grad_faces, height=h, width=w, num_chunks=nc,
        tiles_y=ty, tiles_x=tx, chunk=chunk, tile_h=th, tile_w=tw)
    images = (s["vertices"], s["faces"])
    if crossing.any():
        want_rows, want_counts, want_orig = clip_bbox.packed_on(
            face_data, jgrad_tables, "_grad_face_table", pack, *images,
            monkeypatch=monkeypatch)
    else:
        want_rows, want_counts, want_orig = jax.vmap(pack)(*images)
    np.testing.assert_array_equal(
        np.asarray(want_rows).reshape(rows.shape), rows.numpy())
    np.testing.assert_array_equal(
        np.asarray(want_counts).reshape(batch, -1), counts.numpy())
    np.testing.assert_array_equal(np.asarray(want_orig), sorted_orig.numpy())
    assert (int(counts.max()) == nc * chunk) == cut


def test_tile_face_cap(monkeypatch):
    monkeypatch.delenv("DIRT_TPU_TORCH_TILE_FACE_CAP", raising=False)
    assert forward_pallas.tile_face_cap(100) == 100
    assert forward_pallas.tile_face_cap(10000) == 8192
    monkeypatch.setenv("DIRT_TPU_TORCH_TILE_FACE_CAP", "64")
    assert forward_pallas.tile_face_cap(100) == 64
    monkeypatch.setenv("DIRT_TPU_TORCH_TILE_FACE_CAP", "0")
    assert forward_pallas.tile_face_cap(10000) == 10000


# -- the dense forward ------------------------------------------------------

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
def jax_dense():
    """dirt_tpu's dense forward (Pallas interpret mode) on every scene."""
    return {name: jforward_dense.rasterise_batch(*_args(make()),
                                                 interpret=True)
            for name, make in SCENES.items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dense_forward_matches_jax(jax_dense, scene):
    s = SCENES[scene]()
    th, tw = jforward_dense.tile_shape(*s["background"].shape[1:3])
    got = forward_dense.rasterise_batch(*_torch(s), tile_h=th, tile_w=tw)
    _assert_forward_close(jax_dense[scene], got)


def test_dense_forward_cap_matches_jax(monkeypatch):
    # A cap of 40 faces (one 64-slot chunk) on a one-tile image drops
    # the same hits in both packages.
    s = soup(5, nf=120, h=32, w=128)
    monkeypatch.setenv("DIRT_TPU_TILE_FACE_CAP", "40")
    monkeypatch.setenv("DIRT_TPU_TORCH_TILE_FACE_CAP", "40")
    want = jforward_dense.rasterise_batch(*_args(s), interpret=True)
    th, tw = jforward_dense.tile_shape(32, 128)
    got = forward_dense.rasterise_batch(*_torch(s), tile_h=th, tile_w=tw)
    assert int(np.asarray(want[1].dropped).sum()) > 0
    _assert_forward_close(want, got)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dense_gpu_shape_matches_blocks_and_reference(scene):
    args = _torch(SCENES[scene]())
    dense_px, dense_aux = dispatch.forward_batch(*args, "dense")
    for other in ("blocks", "reference"):
        px, aux = dispatch.forward_batch(*args, other)
        assert torch.equal(dense_aux.face_index, aux.face_index), other
        assert torch.equal(dense_aux.indices, aux.indices), other
        torch.testing.assert_close(dense_px, px, atol=1e-4, rtol=1e-5)
    assert int(dense_aux.dropped.max()) == 0


def test_dense_sweep_plain_is_the_chunk_merge():
    # Walking only the listed hits (as K7 does) or every slot of the live
    # chunks (as the plain version and dirt_tpu do) gives the same state.
    s = SCENES["soup"]()
    bg, v, c, f = _torch(s)
    h, w = bg.shape[1:3]
    ty, tx = _cdiv(h, 16), _cdiv(w, 16)
    face_data, face_ids, counts, _ = forward_pallas._pack_faces(
        v, c, f, h, w, 2, ty, tx, 64, 16, 16)
    rows = face_data.shape[1]
    table = face_data.reshape(-1, face_data.shape[-1])
    ids = (face_ids + rows * torch.arange(2, dtype=torch.int32)[:, None,
                                                                 None])
    ids = ids.reshape(2 * ty * tx, -1)
    args = (3, h, w, tx, ty * tx, 16, 16)
    chunked = forward_dense.dense_sweep_plain(table, ids, counts.reshape(-1),
                                              *args, 64)
    one_by_one = forward_dense.dense_sweep_plain(
        table, ids, counts.reshape(-1), *args, 1)
    assert torch.equal(chunked, one_by_one)


def test_zero_faces_is_background():
    bg = torch.rand(1, 8, 16, 3)
    px, aux = dispatch.forward_batch(bg, torch.rand(1, 5, 4),
                                     torch.rand(1, 5, 3),
                                     torch.zeros(1, 0, 3, dtype=torch.int32),
                                     "dense")
    assert torch.equal(px, bg)
    assert int(aux.face_index.max()) == -1 and aux.dropped.tolist() == [0]


def test_blocks_threshold_selects_dense(monkeypatch):
    monkeypatch.delenv("DIRT_TPU_TORCH_BACKEND", raising=False)
    monkeypatch.delenv("DIRT_TPU_TORCH_BLOCKS_THRESHOLD", raising=False)
    assert dispatch.default_backend("cuda", 512) == "blocks"
    monkeypatch.setenv("DIRT_TPU_TORCH_BLOCKS_THRESHOLD", "600")
    assert dispatch.default_backend("cuda", 512) == "dense"
    assert dispatch.default_backend("cuda", 601) == "blocks"
    assert dispatch.default_backend("cpu", 512) == "reference"
    assert dispatch.GRAD_FOR_BACKEND["dense"] == "dense"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("mosaic", "cpu")


# -- the dense gradient -----------------------------------------------------

@pytest.fixture(scope="module")
def residuals():
    """dirt_tpu's reference forward on the soup, its residuals handed
    across as numpy, and a second cotangent for the fused deferred form."""
    s = SCENES["soup"]()
    px, aux = jdispatch.forward_batch(*_args(s), "reference")
    cot = np.random.RandomState(7).randn(*s["grad"].shape[:3], 5).astype(
        np.float32)
    return s, np.array(px), aux, cot


CASES = {
    "all": dict(parts="all"),
    "position": dict(parts="position"),
    "color": dict(parts="color"),
    "cotangent": dict(parts="all", cot=True),
}


def _port_grads(residuals, case, implementation="dense"):
    s, px, aux, cot = residuals
    t_aux = RasterAux(*(None if a is None else torch.as_tensor(np.array(a))
                        for a in aux))
    return backward.rasterise_grad_batch(
        torch.as_tensor(s["vertices"]), torch.as_tensor(s["faces"]),
        torch.as_tensor(px), torch.as_tensor(s["grad"]), t_aux,
        implementation=implementation, parts=CASES[case]["parts"],
        color_cotangent=(torch.as_tensor(cot) if CASES[case].get("cot")
                         else None))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_grad_matches_jax(residuals, case):
    s, px, aux, cot = residuals
    want = jgrad_dense.rasterise_grad_batch(
        s["vertices"], s["faces"], px, s["grad"], aux, interpret=True,
        parts=CASES[case]["parts"],
        color_cotangent=cot if CASES[case].get("cot") else None)
    got = _port_grads(residuals, case)
    np.testing.assert_array_equal(np.asarray(want.grad_background),
                                  got.grad_background.numpy())
    np.testing.assert_array_equal(np.asarray(want.debug), got.debug.numpy())
    _close(want.grad_vertices, got.grad_vertices.numpy(), "vertices")
    _close(want.grad_vertex_colors, got.grad_vertex_colors.numpy(),
           "vertex colours")
    assert np.abs(got.grad_vertices.numpy()).max() > 0 or case == "color"


@pytest.mark.parametrize("part", ["position", "color"])
def test_dense_parts_rows_bitwise(residuals, part):
    full = _port_grads(residuals, "all")
    one = _port_grads(residuals, part)
    if part == "position":
        assert torch.equal(one.grad_vertices, full.grad_vertices)
        assert int(torch.count_nonzero(one.grad_vertex_colors)) == 0
    else:
        assert torch.equal(one.grad_vertex_colors, full.grad_vertex_colors)
        assert int(torch.count_nonzero(one.grad_vertices)) == 0


@pytest.mark.parametrize("case", ["all", "cotangent"])
def test_dense_grad_matches_plain_scatter(residuals, case):
    want = _port_grads(residuals, case, "xla")
    got = _port_grads(residuals, case, "dense")
    assert torch.equal(want.grad_background, got.grad_background)
    for a, b in ((want.grad_vertices, got.grad_vertices),
                 (want.grad_vertex_colors, got.grad_vertex_colors)):
        _close(a.numpy(), b.numpy(), "rows")


def test_dense_grad_reduce_dead_chunks_are_zero(residuals):
    s, px, aux, _ = residuals
    t = lambda a: torch.as_tensor(np.array(a))
    t_aux = RasterAux(*(None if a is None else t(a) for a in aux))
    h, w = px.shape[1:3]
    planes, _, _ = grad_dense.prepass_and_planes(t(px), t(s["grad"]), t_aux,
                                                 "all")
    from dirt_tpu_torch.ops import prepass_fused
    planes = prepass_fused.tile_planes(planes, 32, 128, 16)
    face_data, face_ids, counts, _ = grad_tables._pack_grad_faces(
        t(s["vertices"]), t(s["faces"]), h, w, 4, 2, 1, 64, 32, 128)
    rows = face_data.shape[1]
    ids = face_ids + rows * torch.arange(2, dtype=torch.int32)[:, None, None]
    out = grad_dense.dense_grad_reduce(
        face_data.reshape(-1, face_data.shape[-1]), ids.reshape(4, -1),
        counts.reshape(-1), planes, 3, "all", 64, h, w, 32, 128)
    live = torch.arange(256)[None] // 64 * 64 < counts.reshape(-1, 1)
    assert bool((out[~live] == 0).all())
    assert bool(live.any()) and not bool(live.all())


def test_dense_step_matches_jax(monkeypatch):
    # The whole differentiable step with the dense backend in both
    # packages: dirt_tpu's dense forward and, through
    # DIRT_TPU_GRAD_BACKEND, its dense gradient (interpret mode).
    s = soup(4, nv=48, nf=80, h=40, w=64)
    weights = s["grad"]
    monkeypatch.setenv("DIRT_TPU_GRAD_BACKEND", "dense")

    def loss(c, col, bg):
        px = dirt_tpu.rasterise_batch(bg, c, col, s["faces"],
                                      backend="dense")
        return jnp.sum(px * weights), px
    (_, want_px), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(s["vertices"]), jnp.asarray(s["colors"]),
        jnp.asarray(s["background"]))
    want_v, want_c, want_bg = (np.asarray(g) for g in grads)

    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("background", "vertices", "colors")]
    px = dirt_tpu_torch.rasterise_batch(*leaves, s["faces"], backend="dense")
    (px * torch.as_tensor(weights)).sum().backward()
    np.testing.assert_allclose(px.detach().numpy(), np.asarray(want_px),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(leaves[0].grad.numpy(), want_bg)
    _close(want_v, leaves[1].grad.numpy(), "vertices")
    _close(want_c, leaves[2].grad.numpy(), "colours")
    assert np.abs(leaves[1].grad.numpy()).max() > 0
