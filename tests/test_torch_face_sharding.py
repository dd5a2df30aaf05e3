"""dirt_tpu_torch.parallel.face_sharding against dirt_tpu's face sharding.

Mirrors tests/test_face_sharding.py's five tests, plus a winner that
belongs to another rank where an id used as an index would be out of
range, and the dry run.  One gloo group of two CPU ranks
(launch.run_ranks) runs every world-size-2 case once for the file, one
of four the 2 x 2 layout; they hand numpy results back.  dirt_tpu runs on
its virtual CPU devices, jitted with XLA's fusion pass off (`jitted`:
every op its own loop, as eager dispatch runs them, so no product and
sum are contracted into an FMA; eager shard_map compiles op by op, tens
of seconds a call).  jax and dirt_tpu are imported inside the tests only:
each rank imports this module afresh.

The forward is held bitwise (pixels and every aux field, with
assert_array_equal, so -0.0 == +0.0: the masked sum makes -0.0 +0.0 in
both packages); the background gradient within atol 2e-6, vertex and
colour gradients within 3e-5 of max(max |want|, 1) (dirt_tpu's
tolerances: the ranks' rows sum in another order than one card's).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dirt_tpu_torch.ops import backward, dispatch
from dirt_tpu_torch.parallel import dryrun, face_sharding, launch
from dirt_tpu_torch.utils import meshes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FIELDS = ("face_index", "indices", "barycentric", "clip_w")
TOL = 3e-5


def soup(seed, nf=48, nv=60, batch=2, h=40, w=64, c=3):
    """tests/test_face_sharding.py's _soup: (v, f, colors, bg, weights)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = np.abs(v[..., 3]) + 0.5
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    colors = rng.uniform(size=(batch, nv, c)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, c)).astype(np.float32)
    weights = rng.randn(batch, h, w, c).astype(np.float32)
    return v, f, colors, bg, weights


def occlusion():
    """tests/test_face_sharding.py's cross-shard scene: front pair then
    back pair, so the two squares land on different ranks."""
    rng = np.random.RandomState(5)
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, size=0.7, back_size=0.95)
    c = rng.uniform(size=(1, 8, 3)).astype(np.float32)
    bg = rng.uniform(size=(1, 32, 48, 3)).astype(np.float32)
    w = rng.randn(1, 32, 48, 3).astype(np.float32)
    return verts[None], faces[None], c, bg, w


def one_face_each():
    """Two overlapping triangles, one a rank: the front one (rank 1's)
    wins over most of the back one (rank 0's), so each rank's combined
    ids hold the other's winners, which index nothing of its one-row
    table."""
    v = np.array([[[-0.9, -0.9, 0.5, 1.], [-0.9, 0.9, 0.5, 1.],
                   [0.9, -0.9, 0.5, 1.],
                   [-0.5, -0.6, 0.0, 1.], [-0.4, 0.7, 0.0, 1.],
                   [0.6, -0.3, 0.0, 1.]]], np.float32)
    f = np.array([[[0, 1, 2], [3, 4, 5]]], np.int32)
    rng = np.random.RandomState(31)
    c = rng.uniform(size=(1, 6, 3)).astype(np.float32)
    bg = rng.uniform(size=(1, 24, 32, 3)).astype(np.float32)
    w = rng.randn(1, 24, 32, 3).astype(np.float32)
    return v, f, c, bg, w


def _forward(mesh, scene, **kw):
    v, f, c, bg, _ = scene
    px, aux = face_sharding.rasterise_batch_face_sharded_with_aux(
        mesh, bg, v, c, f, device="cpu", **kw)
    return (px.numpy(), {name: getattr(aux, name).numpy()
                         for name in FIELDS + ("dropped",)})


def _grads(mesh, scene, **kw):
    v, f, c, bg, w = scene
    leaves = [torch.tensor(a, requires_grad=True) for a in (bg, v, c)]
    px = face_sharding.rasterise_batch_face_sharded(
        mesh, *leaves, torch.tensor(f), **kw)
    weights = _local(mesh, w) if "batch_axis" in kw else torch.tensor(w)
    (px * weights).sum().backward()
    return px.detach().numpy(), [x.grad.numpy() for x in leaves]


def _local(mesh, array):
    """This rank's rows of `array` on the 2-D mesh's batch axis."""
    rank, size = mesh.get_local_rank("batch"), mesh.size(0)
    shard = array.shape[0] // size
    return torch.tensor(array[rank * shard:(rank + 1) * shard])


def _no_scatter_gradient(*args, **kwargs):
    raise AssertionError("the face-sharded backward reached the 'xla' "
                         "scatter gradient")


def _rank_cases():
    torch.set_num_threads(1)
    # Every face-sharded backward must run the blocks gradient, which only
    # compares face ids: the scatter gradient indexes with them.
    backward.rasterise_grad_xla = _no_scatter_gradient
    mesh = face_sharding.make_face_mesh(device_type="cpu")
    out = {"forward": _forward(mesh, soup(19)),
           "forward pixels": _grads(mesh, soup(19))[0],
           "gradients": _grads(mesh, soup(23))[1],
           "occlusion": (_forward(mesh, occlusion()),
                         _grads(mesh, occlusion())[1]),
           "one face each": (_forward(mesh, one_face_each()),
                             _grads(mesh, one_face_each())[1])}
    v, f, c, bg, _ = soup(1, nf=45)
    try:
        face_sharding.rasterise_batch_face_sharded(mesh, bg, v, c, f,
                                                   device="cpu")
    except ValueError as error:
        out["divisibility"] = str(error)
    return out


def _rank_2d():
    torch.set_num_threads(1)
    mesh = face_sharding.make_face_mesh(device_type="cpu", batch_shards=2)
    return _grads(mesh, soup(29), batch_axis="batch")


@pytest.fixture(scope="module")
def ranks():
    return launch.run_ranks(2, _rank_cases, backend="gloo", device="cpu")


def jitted(fn):
    """jax.jit without XLA's fusion pass (module docstring)."""
    import jax
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "fusion"})


def _jax_face_mesh(n):
    import jax
    from dirt_tpu.parallel import face_sharding as jface_sharding
    return jface_sharding.make_face_mesh(jax.devices()[:n])


def _port_unsharded(scene):
    """The port's unsharded forward (reference backend) and its blocks
    gradient of sum(pixels * weights): (pixels, aux, [bg, v, c] grads)."""
    v, f, c, bg, w = (torch.tensor(a) for a in scene)
    px, aux = dispatch.forward_batch(bg, v, c, f)
    grads = backward.rasterise_grad_grouped(v, f, px, w, aux,
                                            implementation="blocks")
    return px.numpy(), aux, [g.numpy() for g in grads]


def _jax_grads(scene, argnums=(0, 1, 2)):
    import jax
    import jax.numpy as jnp
    import dirt_tpu
    v, f, c, bg, w = scene
    loss = lambda b, vv, cc: jnp.sum(dirt_tpu.rasterise_batch(b, vv, cc, f)
                                     * w)
    return [np.asarray(g) for g in jitted(jax.grad(loss, argnums))(bg, v, c)]


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _assert_forward_equal(got, want_px, want_aux):
    px, aux = got
    np.testing.assert_array_equal(px, want_px)
    for name in FIELDS:
        np.testing.assert_array_equal(aux[name], np.asarray(
            getattr(want_aux, name)))


def test_forward_matches_unsharded(ranks):
    from dirt_tpu.parallel import face_sharding as jface_sharding
    scene = soup(19)
    v, f, c, bg, _ = scene
    mesh = _jax_face_mesh(2)
    jpx, jaux = jitted(lambda *a: jface_sharding.
                       rasterise_batch_face_sharded_with_aux(mesh, *a))(
        bg, v, c, f)
    want_px, want_aux, _ = _port_unsharded(scene)
    for r in ranks:
        _assert_forward_equal(r["forward"], np.asarray(jpx), jaux)
        _assert_forward_equal(r["forward"], want_px, want_aux)
        assert int(r["forward"][1]["dropped"].sum()) == 0
        np.testing.assert_array_equal(r["forward pixels"], want_px)


def test_gradients_match_unsharded(ranks):
    scene = soup(23)
    jgrads = _jax_grads(scene)
    _, _, pgrads = _port_unsharded(scene)
    for r in ranks:
        got = r["gradients"]
        np.testing.assert_allclose(got[0], jgrads[0], atol=2e-6, rtol=3e-7)
        np.testing.assert_array_equal(got[0], pgrads[0])
        for g, jw, pw in zip(got[1:], jgrads[1:], pgrads[1:]):
            _close(g, jw)
            _close(g, pw)
    np.testing.assert_array_equal(ranks[0]["gradients"][1],
                                  ranks[1]["gradients"][1])


def test_cross_shard_occlusion(ranks):
    scene = occlusion()
    want_px, want_aux, pgrads = _port_unsharded(scene)
    jgrads = _jax_grads(scene, argnums=(1, 2))
    for r in ranks:
        forward, grads = r["occlusion"]
        _assert_forward_equal(forward, want_px, want_aux)
        ids = forward[1]["face_index"]
        winners = np.unique(ids[ids >= 0])
        assert (winners < 2).any() and (winners >= 2).any()
        # the front square (faces 0, 1) wins where both squares cover
        assert (ids[:, 16, 24] < 2).all()
        for g, jw, pw in zip(grads[1:], jgrads, pgrads[1:]):
            _close(g, jw)
            _close(g, pw)


def test_2d_mesh_batch_by_faces():
    import jax
    from jax.sharding import Mesh
    from dirt_tpu.parallel import face_sharding as jface_sharding
    results = launch.run_ranks(4, _rank_2d, backend="gloo", device="cpu")
    scene = soup(29)
    v, f, c, bg, _ = scene
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("batch", jface_sharding.FACE_AXIS))
    jpx = np.asarray(jitted(lambda *a: jface_sharding.
                            rasterise_batch_face_sharded(
                                mesh, *a, batch_axis="batch"))(bg, v, c, f))
    got = np.concatenate([results[0][0], results[2][0]])
    np.testing.assert_array_equal(got, jpx)
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(got, _port_unsharded(scene)[0])
    # Each batch group's vertex gradient fills its own rows only.
    grad_v = results[0][1][1] + results[2][1][1]
    assert not results[0][1][1][1].any() and not results[2][1][1][0].any()
    np.testing.assert_array_equal(results[0][1][1], results[1][1][1])
    _close(grad_v, _jax_grads(scene, argnums=(1,))[0])


def test_face_count_divisibility_raises(ranks):
    for r in ranks:
        assert "not divisible" in r["divisibility"]
        assert "45" in r["divisibility"]


def test_foreign_winner_is_never_an_index(ranks):
    scene = one_face_each()
    want_px, want_aux, pgrads = _port_unsharded(scene)
    for r in ranks:
        forward, grads = r["one face each"]
        _assert_forward_equal(forward, want_px, want_aux)
        ids = forward[1]["face_index"]
        assert (ids == 0).any() and (ids == 1).any()
        np.testing.assert_array_equal(grads[0], pgrads[0])
        for g, pw in zip(grads[1:], pgrads[1:]):
            assert np.abs(g).sum() > 0
            _close(g, pw)


def test_dryrun_multichip_on_the_cpu():
    ranks = dryrun.dryrun_multichip(2, device="cpu")
    assert len(ranks) == 2 and ranks[0].keys() == ranks[1].keys() == {
        "fit None", "fit dense", "fit blocks", "deferred", "face-sharded"}
    for name, record in ranks[0].items():
        # the losses are reduced over the ranks; the CPU runs no kernel
        assert record["loss"] == ranks[1][name]["loss"]
        assert np.isfinite(record["loss"]) and record["launches"] == {}
