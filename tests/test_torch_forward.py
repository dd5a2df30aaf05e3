"""dirt_tpu_torch's forward against dirt_tpu's on the CPU.

Both packages read the same seeded numpy scenes.  Winner maps, vertex-index
maps and dropped counts must be equal; pixels, barycentrics and clip w
agree within atol=1e-4, rtol=1e-5 (bench.py's oracle tolerance: the JAX
blocks kernel in interpret mode lets XLA contract some products, eager
PyTorch never does).  The reference backend is compared bitwise.  The
blocks schedule runs here with its kernels' plain versions (the CUDA
kernels K1 and K4 are held against those on the card by chip_smoke.py); it
is called at dirt_tpu's tile shapes (4x128 tiles, 64-face blocks) where its
hit plane and CSR runs must equal dirt_tpu's bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dirt_tpu
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_blocks as jforward_blocks
from dirt_tpu.ops import forward_pallas as jforward_pallas
from dirt_tpu.ops import grad_tables as jgrad_tables
import dirt_tpu_torch
from dirt_tpu_torch.ops import (dispatch, forward_blocks, forward_pallas,
                                grad_tables)
from dirt_tpu_torch.utils import convert, meshes, oracle


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


def soup(seed, batch=2, nv=60, nf=120, h=64, w=128, crossing=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    return dict(background=bg, vertices=v, colors=c, faces=f)


SCENES = {
    "soup": lambda: soup(0),
    "crossing": lambda: soup(1, crossing=True),
    "unaligned48x80": lambda: soup(3, nf=90, h=48, w=80),
}


def _args(scene):
    return (scene["background"], scene["vertices"], scene["colors"],
            scene["faces"])


def _torch(scene):
    t = convert.scene_to_torch(scene, "cpu")
    return t["background"], t["vertices"], t["colors"], t["faces"]


def _assert_forward_close(want, got, exact=False):
    want_px, want_aux = want
    got_px, got_aux = got
    got_aux = convert.aux_to_numpy(got_aux)
    for name in ("face_index", "indices", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(got_aux, name), err_msg=name)
    pairs = [("pixels", want_px, got_px.numpy()),
             ("barycentric", want_aux.barycentric, got_aux.barycentric),
             ("clip_w", want_aux.clip_w, got_aux.clip_w)]
    for name, a, b in pairs:
        if exact:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        else:
            np.testing.assert_allclose(np.asarray(a), b, atol=1e-4,
                                       rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_blocks():
    """dirt_tpu's blocks backend (Pallas interpret mode) on every scene."""
    return {name: jdispatch.forward_batch(*_args(make()), "blocks")
            for name, make in SCENES.items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_reference_matches_jax_bitwise(scene):
    s = SCENES[scene]()
    want = jdispatch.forward_batch(*_args(s), "reference")
    got = dispatch.forward_batch(*_torch(s), "reference")
    _assert_forward_close(want, got, exact=True)


def test_reference_matches_oracle_at_intersection_near_ties():
    # On this soup dirt_tpu's XLA reference picks a different winner than
    # the strictly rounded native oracle at 14 pixels along triangle
    # intersections (XLA contracts s_w / s_z into FMAs there); the port
    # rounds every product, as the oracle does, and agrees with it.
    s = soup(2, nf=90, h=48, w=80)
    _, aux = dispatch.forward_batch(*_torch(s), "reference")
    for b in range(2):
        _, want = oracle.rasterise(s["background"][b], s["vertices"][b],
                                   s["colors"][b], s["faces"][b])
        np.testing.assert_array_equal(aux.face_index[b].numpy(), want)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blocks_matches_jax_blocks(jax_blocks, scene):
    got = forward_blocks.rasterise_batch(*_torch(SCENES[scene]()),
                                         **JAX_TILE)
    _assert_forward_close(jax_blocks[scene], got)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blocks_gpu_shape_matches_reference(scene):
    # The default (GPU) tile shape: the same winners as the reference.
    args = _torch(SCENES[scene]())
    want_px, want_aux = dispatch.forward_batch(*args, "reference")
    got_px, got_aux = dispatch.forward_batch(*args, "blocks")
    torch.testing.assert_close(got_aux.face_index, want_aux.face_index,
                               rtol=0, atol=0)
    torch.testing.assert_close(got_aux.indices, want_aux.indices,
                               rtol=0, atol=0)
    torch.testing.assert_close(got_px, want_px, atol=1e-4, rtol=1e-5)
    assert int(got_aux.dropped.max()) == 0


@pytest.mark.parametrize("table", ["forward", "grad"])
@pytest.mark.parametrize("edges", [False, True])
def test_hit_matrix_matches_jax_bitwise(table, edges):
    # tests/test_hit_kernel.py's setup: 16-face blocks, 4x128 tiles.
    s = soup(31, nf=45, h=64, w=64)
    height = width = 64
    chunk, th, tw = 16, 4, 128
    nb = -(-45 // chunk)
    pad = nb * chunk - 45
    ty, tx = -(-height // th), -(-width // tw)
    v, c, f = s["vertices"], s["colors"], s["faces"]
    if table == "forward":
        def one(vv, cc, ff):
            fd = jforward_pallas._face_table(vv, cc, ff, height, width, pad)
            return fd, jforward_blocks.hit_matrix(
                fd, (20, 21, 22, 23), nb, chunk, ty, tx, th, tw,
                edge_cols=0 if edges else None, height=height, width=width)
        want_fd, want = jax.vmap(one)(v, c, f)
        fd = forward_pallas._face_table(*(torch.as_tensor(a) for a in
                                          (v, c, f)), height, width, pad)
        got = forward_blocks.hit_matrix(
            fd, (20, 21, 22, 23), nb, chunk, ty, tx, th, tw,
            edge_cols=0 if edges else None, height=height, width=width)
    else:
        def one(vv, ff):
            fd = jgrad_tables._grad_face_table(vv, ff, height, width, pad)
            return fd, jforward_blocks.hit_matrix(
                fd, (0, 1, 2, 3), nb, chunk, ty, tx, th, tw,
                edge_cols=12 if edges else None, height=height, width=width,
                dilate=1)
        want_fd, want = jax.vmap(one)(v, f)
        fd = grad_tables._grad_face_table(torch.as_tensor(v),
                                          torch.as_tensor(f), height, width,
                                          pad)
        got = forward_blocks.hit_matrix(
            fd, (0, 1, 2, 3), nb, chunk, ty, tx, th, tw,
            edge_cols=12 if edges else None, height=height, width=width,
            dilate=1)
    np.testing.assert_array_equal(np.asarray(want_fd), fd.numpy())
    assert np.asarray(want).sum() > 0
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_build_runs_matches_jax_bitwise(seed):
    # Random hit matrices and budgets, truncating ones included.
    rng = np.random.RandomState(seed)
    r, i = rng.randint(2, 30), rng.randint(2, 30)
    hits = rng.rand(3, r, i) < rng.uniform(0.05, 0.9)
    slots = int(rng.randint(1, r * i + 4))
    got = forward_blocks.build_runs(torch.as_tensor(hits), slots)
    for b in range(3):
        want = jforward_blocks.build_runs(jnp.asarray(hits[b]), slots)
        for name, w, g in zip(("starts", "counts", "ids", "dropped"), want,
                              got):
            np.testing.assert_array_equal(np.asarray(w), g[b].numpy(),
                                          err_msg=name)


def test_build_runs_truncation_counts_lost_visits():
    hit = torch.ones(1, 4, 3, dtype=torch.bool)          # 12 visits
    starts, counts, ids, dropped = forward_blocks.build_runs(hit, 7)
    assert int(dropped[0]) == 5
    assert counts[0].tolist() == [3, 3, 1, 0]
    assert starts[0].tolist() == [0, 3, 6, 7]


def test_spatial_order_matches_jax():
    s = soup(8, nf=100)
    h, w = 64, 128
    want = jax.vmap(lambda vv, cc, ff: jforward_blocks.spatial_order(
        jforward_pallas._face_table(vv, cc, ff, h, w, 28),
        (20, 21, 22, 23), 4, 128))(s["vertices"], s["colors"], s["faces"])
    fd = forward_pallas._face_table(
        *(torch.as_tensor(s[k]) for k in ("vertices", "colors", "faces")),
        h, w, 28)
    got = forward_blocks.spatial_order(fd, (20, 21, 22, 23), 4, 128)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _full_screen(num_faces, h, w):
    rng = np.random.RandomState(0)
    v = []
    for k in range(num_faces):
        z = -0.9 + 1.8 * k / num_faces     # front to back, distinct depths
        v += [[-3., -3., z, 1.], [3., -3., z, 1.], [0., 3., z, 1.]]
    return dict(background=rng.uniform(size=(1, h, w, 3)).astype(np.float32),
                vertices=np.asarray(v, np.float32)[None],
                colors=rng.uniform(size=(1, 3 * num_faces, 3)).astype(
                    np.float32),
                faces=np.arange(3 * num_faces, dtype=np.int32).reshape(
                    1, num_faces, 3))


def test_dropped_under_truncating_budget_matches_jax(monkeypatch):
    # 8 tiles x 1 block = 8 live visits; a 5-slot budget drops 3, and the
    # truncated tiles degrade to background in both packages.
    s = _full_screen(20, 32, 128)
    monkeypatch.setenv("DIRT_TPU_SLOTS_PER_IMAGE", "5")
    monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", "5")
    want = jdispatch.forward_batch(*_args(s), "blocks")
    got = forward_blocks.rasterise_batch(*_torch(s), **JAX_TILE)
    assert int(np.asarray(want[1].dropped)[0]) == 3
    _assert_forward_close(want, got)
    monkeypatch.delenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE")
    _, exact = forward_blocks.rasterise_batch(*_torch(s), **JAX_TILE)
    _, ref = dispatch.forward_batch(*_torch(s), "reference")
    assert int(exact.dropped[0]) == 0
    assert torch.equal(exact.face_index, ref.face_index)


# -- the square test (tests/test_square.py): pixel-exact coverage --------

def _square_scene():
    size, cx, cy, canvas = 16, 32, 64, 128
    sq = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32) * size
    sq = (sq - size / 2. + [cx, cy]) * 2. / [canvas, canvas] - 1.
    verts = np.concatenate([sq, np.zeros([4, 1], np.float32),
                            np.ones([4, 1], np.float32)], axis=1)
    xs, ys = np.meshgrid(np.arange(canvas), np.arange(canvas))
    expected = ((np.abs(xs + 0.5 - cx) <= size / 2)
                & (np.abs(ys + 0.5 - cy) <= size / 2)).astype(np.float32)
    return (verts.astype(np.float32), np.array([[0, 1, 2], [0, 2, 3]],
                                               np.int32), expected)


@pytest.mark.parametrize("backend,shape", [
    ("reference", None), ("blocks", None), ("blocks", "jax")])
def test_square_pixels_exact(backend, shape):
    verts, faces, expected = _square_scene()
    args = (torch.zeros(1, 128, 128, 1), torch.as_tensor(verts)[None],
            torch.ones(1, 4, 1), torch.as_tensor(faces)[None])
    if shape == "jax":
        pixels, _ = forward_blocks.rasterise_batch(*args, **JAX_TILE)
        pixels = pixels[0]
    else:
        pixels = dirt_tpu_torch.rasterise(*(a[0] for a in args),
                                          backend=backend)
    got = pixels[:, :, 0].numpy()
    assert int(np.sum(expected != got)) == 0


# -- the native C++ oracle ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["reference", "blocks"])
def test_native_oracle(seed, backend):
    rng = np.random.RandomState(seed)
    v = rng.randn(50, 4).astype(np.float32)
    v[:, 3] = np.abs(v[:, 3]) + 0.4
    f = rng.randint(0, 50, size=(35, 3)).astype(np.int32)
    c = rng.uniform(size=(50, 3)).astype(np.float32)
    bg = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    want_px, want_index = oracle.rasterise(bg, v, c, f)
    pixels, aux = dispatch.forward_batch(
        *(torch.as_tensor(a)[None] for a in (bg, v, c, f)), backend)
    np.testing.assert_array_equal(aux.face_index[0].numpy(), want_index)
    if backend == "reference":
        np.testing.assert_array_equal(pixels[0].numpy(), want_px)
    else:
        np.testing.assert_allclose(pixels[0].numpy(), want_px, atol=1e-4,
                                   rtol=1e-5)


def test_cylinder_matches_oracle_and_jax():
    v, f = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, 16)
    rot = np.array([[1, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]], np.float32)
    clip = np.concatenate([(v @ rot) * 0.8,
                           np.full((v.shape[0], 1), 1.5, np.float32)], 1)
    rng = np.random.RandomState(6)
    c = rng.uniform(size=(v.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    want_px, want_index = oracle.rasterise(bg, clip, c, f)
    j_px = dirt_tpu.rasterise(bg, clip, c, f)
    t_px, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        *(torch.as_tensor(a)[None] for a in (bg, clip, c, f)),
        backend="blocks")
    np.testing.assert_array_equal(aux.face_index[0].numpy(), want_index)
    np.testing.assert_allclose(t_px[0].numpy(), want_px, atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(t_px[0].numpy(), np.asarray(j_px), atol=1e-4,
                               rtol=1e-5)


def test_zero_faces_is_background():
    bg = torch.rand(1, 8, 16, 3)
    for backend in ("reference", "blocks"):
        px, aux = dispatch.forward_batch(bg, torch.rand(1, 5, 4),
                                         torch.rand(1, 5, 3),
                                         torch.zeros(1, 0, 3,
                                                     dtype=torch.int32),
                                         backend)
        assert torch.equal(px, bg)
        assert int(aux.face_index.max()) == -1


def test_forward_batch_validates_inputs():
    bg, v, c, f = _torch(soup(0, nf=4, h=8, w=8))
    with pytest.raises(ValueError):
        dispatch.forward_batch(bg[0], v, c, f)
    with pytest.raises(ValueError):
        dispatch.forward_batch(bg, v[..., :3], c, f)
    with pytest.raises(ValueError):
        dispatch.forward_batch(bg, v, c[..., :2], f)
    with pytest.raises(ValueError):
        dispatch.forward_batch(bg, v, c, f, backend="mosaic")


def test_default_backend_by_device(monkeypatch):
    monkeypatch.delenv("DIRT_TPU_TORCH_BACKEND", raising=False)
    assert dispatch.default_backend("cpu") == "reference"
    assert dispatch.default_backend("cuda") == "blocks"
    monkeypatch.setenv("DIRT_TPU_TORCH_BACKEND", "blocks")
    assert dispatch.default_backend("cpu") == "blocks"
