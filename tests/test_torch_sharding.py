"""dirt_tpu_torch.parallel.sharding against dirt_tpu.parallel.sharding.

Mirrors tests/test_sharding.py's six tests at world size 2: one gloo
group of two CPU ranks (launch.run_ranks) runs every case once, for the
whole file, and hands numpy results back; dirt_tpu runs on a 2-device
mesh of its virtual CPU devices, jitted with XLA's fusion pass off
(`jitted`: every op its own loop, as eager dispatch runs them, so no
product and sum are contracted into an FMA, which would move pixels by
an ulp; eager shard_map compiles op by op, tens of seconds a call).  jax
and dirt_tpu are imported inside the tests only: each rank imports this
module afresh.

Tolerances are dirt_tpu's own: sharded pixels == unsharded (and ==
dirt_tpu's sharded pixels), vertex gradients within rtol/atol 1e-6 of the
unsharded port on the reference backend, the bounded-flip check on the
decision-stable square for "dense" and "blocks" (which run their
kernels' plain versions here), the fit step within 1e-5 of dirt_tpu's,
the deferred gradients within rtol 1e-5 / atol 1e-6.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dirt_tpu_torch
from dirt_tpu_torch import lighting
from dirt_tpu_torch.models import renderers
from dirt_tpu_torch.parallel import launch, sharding
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


H, W = 24, 32
WORLD = 2
BATCH = 4
QUAD = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
SQUARE = np.array([[-0.4, -0.4, 0., 1.], [-0.4, 0.4, 0., 1.],
                   [0.4, 0.4, 0., 1.], [0.4, -0.4, 0., 1.]], np.float32)
FIT_STEPS = 8
FIT_TARGET = np.array([0.15, -0.1], np.float32)


def batch_scene(batch=BATCH):
    """tests/test_sharding.py's _batch_scene: (bg, v, colors, faces)."""
    rng = np.random.RandomState(0)
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, size=0.8, back_size=0.9)
    v = np.stack([verts + np.array([0.05 * i, 0.02 * i, 0, 0], np.float32)
                  for i in range(batch)])
    colors = rng.uniform(size=(batch, 8, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, H, W, 3)).astype(np.float32)
    f = np.broadcast_to(faces, (batch,) + faces.shape).copy()
    return bg, v, colors, f


def stable_scene(batch=BATCH):
    """The decision-stable square of tests/test_sharding.py:96-108."""
    v = np.stack([SQUARE + np.array([0.04 * i, 0.02 * i, 0, 0], np.float32)
                  for i in range(batch)])
    f = np.broadcast_to(QUAD, (batch, 2, 3)).copy()
    c = np.full((batch, 4, 3), 0.7, np.float32)
    bg = np.full((batch, H, W, 3), 0.2, np.float32)
    w = np.random.RandomState(7).randn(batch, H, W, 3).astype(np.float32)
    return bg, v, c, f, w


def fit_vertices(offset):
    return torch.as_tensor(SQUARE) + torch.cat([offset, torch.zeros(2)])


def fit_render(params, shard):
    one = dirt_tpu_torch.rasterise(
        torch.zeros(H, W, 1), fit_vertices(params["offset"]),
        torch.ones(4, 1), torch.as_tensor(QUAD))
    return one[None].expand(shard, -1, -1, -1)


def deferred_scene():
    v_obj, f_obj = meshes.build_cube()
    rots = np.stack([[0., 0.3 + 0.05 * i, 0.] for i in range(BATCH)]).astype(
        np.float32)
    light = np.array([0.6, -0.4, 0.2], np.float32)
    targets = np.random.RandomState(11).uniform(
        size=(BATCH, H, W, 3)).astype(np.float32)
    return v_obj, f_obj, rots, light, targets


def deferred_loss(rots, light, targets):
    """sum over images of the deferred Phong cube's L2 loss."""
    v_obj, f_obj = meshes.build_cube()
    v_obj, f_obj = lighting.split_vertices_by_face(v_obj, f_obj,
                                                   device="cpu")
    renderer = renderers.DeferredPhongRenderer(width=W, height=H)
    albedo = torch.full((v_obj.shape[0], 3), 0.6)
    return sum(torch.sum((renderer.render(v_obj, f_obj, albedo, rots[i],
                                          light) - targets[i]) ** 2)
               for i in range(rots.shape[0]))


def _grad_of(loss_fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    grads = torch.autograd.grad(loss_fn(*leaves), leaves)
    return [g.numpy() for g in grads]


def _env(name, value):
    saved = os.environ.get(name)
    os.environ[name] = value
    return lambda: (os.environ.pop(name) if saved is None
                    else os.environ.__setitem__(name, saved))


def _rank_cases():
    """Every case's local results on this rank (numpy)."""
    torch.set_num_threads(1)
    mesh = sharding.make_mesh(device_type="cpu")
    out = {}
    bg, v, c, f = (torch.as_tensor(a) for a in sharding.batch_sharded(
        mesh, [torch.as_tensor(a) for a in batch_scene()]))
    out["pixels"] = sharding.rasterise_batch_sharded(mesh, bg, v, c,
                                                     f).numpy()
    weights = sharding.batch_sharded(mesh, torch.as_tensor(
        np.random.RandomState(1).randn(BATCH, H, W, 3).astype(np.float32)))
    out["grad_v"], = _grad_of(lambda v_: torch.sum(
        sharding.rasterise_batch_sharded(mesh, bg, v_, c, f) * weights),
        v.numpy())

    sbg, sv, sc, sf, sw = sharding.batch_sharded(
        mesh, [torch.as_tensor(a) for a in stable_scene()])
    bbg, bv, bc, bf = sharding.batch_sharded(
        mesh, [torch.as_tensor(a) for a in batch_scene()])
    for backend in ("dense", "blocks"):
        restore = _env("DIRT_TPU_TORCH_GRAD_BACKEND", backend)
        try:
            out[f"{backend} pixels"] = sharding.rasterise_batch_sharded(
                mesh, bbg, bv, bc, bf, backend=backend).numpy()
            out[f"{backend} grad_v"], = _grad_of(lambda v_: torch.sum(
                sharding.rasterise_batch_sharded(
                    mesh, sbg, v_, sc, sf, backend=backend) * sw),
                sv.numpy())
        finally:
            restore()

    # The fit: every image's target the same (dirt_tpu's test), then one
    # step on distinct targets.
    target = fit_render({"offset": torch.as_tensor(FIT_TARGET)}, 1)
    targets = sharding.batch_sharded(mesh, target.expand(BATCH, -1, -1, -1))
    params = sharding.replicated(mesh, {"offset": torch.zeros(2)})
    losses = []
    for _ in range(FIT_STEPS):
        params, loss = sharding.data_parallel_fit_step(
            mesh, fit_render, params, targets, learning_rate=0.3)
        losses.append(float(loss))
    out["fit losses"], out["fit offset"] = losses, params["offset"].numpy()
    distinct = sharding.batch_sharded(mesh, torch.as_tensor(
        np.random.RandomState(2).uniform(size=(BATCH, H, W, 1)).astype(
            np.float32)))
    start = {"offset": torch.tensor([0.05, -0.02])}
    stepped, loss = sharding.data_parallel_fit_step(
        mesh, fit_render, start, distinct, learning_rate=0.3)
    out["distinct offset"], out["distinct loss"] = (
        stepped["offset"].numpy(), float(loss))

    _, _, rots, light, dtargets = deferred_scene()
    rots_l, targets_l = sharding.batch_sharded(
        mesh, [torch.as_tensor(rots), torch.as_tensor(dtargets)])
    leaves = [rots_l.clone().requires_grad_(True),
              torch.tensor(light, requires_grad=True)]
    g_rots, g_light = torch.autograd.grad(
        deferred_loss(leaves[0], leaves[1], targets_l), leaves)
    dist.all_reduce(g_light)
    out["deferred"] = (g_rots.numpy(), g_light.numpy())
    return out


def _raise_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def _exit_on_rank_one():
    if dist.get_rank() == 1:
        sys.exit(3)
    dist.barrier()


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results, in rank order."""
    return launch.run_ranks(WORLD, _rank_cases, backend="gloo",
                            device="cpu")


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def jitted(fn):
    """jax.jit without XLA's fusion pass (module docstring)."""
    import jax
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "fusion"})


def _jax_mesh():
    import jax
    from dirt_tpu.parallel import sharding as jsharding
    return jsharding.make_mesh(jax.devices()[:WORLD])


def test_sharded_matches_unsharded(ranks):
    import jax
    from dirt_tpu.parallel import sharding as jsharding
    got = _gathered(ranks, "pixels")
    scene = batch_scene()
    want = dirt_tpu_torch.rasterise_batch(*scene, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    mesh = _jax_mesh()
    theirs = np.asarray(jitted(lambda *a: jsharding.rasterise_batch_sharded(
        mesh, *a))(*scene))
    np.testing.assert_array_equal(got, theirs)


def test_sharded_gradients_match_unsharded(ranks):
    import jax
    import jax.numpy as jnp
    from dirt_tpu.parallel import sharding as jsharding
    got = _gathered(ranks, "grad_v")
    bg, v, c, f = batch_scene()
    weights = np.random.RandomState(1).randn(BATCH, H, W, 3).astype(
        np.float32)
    want, = _grad_of(lambda v_: torch.sum(dirt_tpu_torch.rasterise_batch(
        torch.as_tensor(bg), v_, torch.as_tensor(c), torch.as_tensor(f))
        * torch.as_tensor(weights)), v)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (np.abs(got).sum(axis=(1, 2)) > 0).all()
    mesh = _jax_mesh()
    theirs = np.asarray(jitted(jax.grad(lambda v_: jnp.sum(
        jsharding.rasterise_batch_sharded(mesh, bg, v_, c, f) * weights)))(v))
    scale = max(np.abs(theirs).max(), 1.0)
    np.testing.assert_allclose(got / scale, theirs / scale, atol=3e-6)


@pytest.mark.parametrize("backend", ["dense", "blocks"])
def test_kernel_backends_under_sharding(ranks, backend):
    got = _gathered(ranks, f"{backend} pixels")
    scene = batch_scene()
    want = np.concatenate([dirt_tpu_torch.rasterise_batch(
        *(a[i:i + 1] for a in scene), backend=backend, device="cpu").numpy()
        for i in range(BATCH)])
    np.testing.assert_array_equal(got, want)

    got = _gathered(ranks, f"{backend} grad_v")
    bg, v, c, f, w = stable_scene()
    restore = _env("DIRT_TPU_TORCH_GRAD_BACKEND", backend)
    try:
        want = np.concatenate([_grad_of(
            lambda v_: torch.sum(dirt_tpu_torch.rasterise_batch(
                torch.as_tensor(bg[i:i + 1]), v_,
                torch.as_tensor(c[i:i + 1]), torch.as_tensor(f[i:i + 1]),
                backend=backend) * torch.as_tensor(w[i:i + 1])),
            v[i:i + 1])[0] for i in range(BATCH)])
    finally:
        restore()
    # dirt_tpu's bounded-flip check (tests/test_sharding.py:133-139).
    diff = np.abs(got - want)
    scale = max(np.abs(want).max(), 1.0)
    assert diff.max() / scale < 2e-3, diff.max()
    assert (diff > 1e-5 * scale).mean() < 0.2
    assert (np.abs(got).sum(axis=(1, 2)) > 0).all()


def test_data_parallel_fit_step_reduces_loss(ranks):
    import functools
    import jax
    import jax.numpy as jnp
    import dirt_tpu
    from dirt_tpu.parallel import sharding as jsharding
    losses = ranks[0]["fit losses"]
    assert losses[-1] < losses[0], losses
    np.testing.assert_array_equal(ranks[0]["fit offset"],
                                  ranks[1]["fit offset"])
    assert ranks[0]["fit losses"] == ranks[1]["fit losses"]
    moved = ranks[0]["fit offset"]
    assert np.linalg.norm(moved - FIT_TARGET) < np.linalg.norm(FIT_TARGET)

    def render_fn(params, shard):
        vertices = jnp.asarray(SQUARE) + jnp.concatenate(
            [params["offset"], jnp.zeros(2)])[None, :]
        one = dirt_tpu.rasterise(jnp.zeros((H, W, 1)), vertices,
                                 jnp.ones((4, 1)), QUAD)
        return jnp.tile(one[None], (shard, 1, 1, 1))

    mesh = _jax_mesh()
    target = render_fn({"offset": jnp.asarray(FIT_TARGET)}, BATCH)
    targets = jsharding.batch_sharded(mesh, target)
    params = jsharding.replicated(mesh, {"offset": jnp.zeros(2)})
    step = jitted(functools.partial(jsharding.data_parallel_fit_step, mesh,
                                     render_fn, learning_rate=0.3))
    theirs = []
    for _ in range(FIT_STEPS):
        params, loss = step(params, targets)
        theirs.append(float(loss))
    np.testing.assert_allclose(moved, np.asarray(params["offset"]),
                               atol=1e-5)
    np.testing.assert_allclose(losses, theirs, rtol=1e-5, atol=1e-7)

    # Distinct targets: one step equals the unsharded gradient step.
    distinct = torch.as_tensor(np.random.RandomState(2).uniform(
        size=(BATCH, H, W, 1)).astype(np.float32))
    offset = torch.tensor([0.05, -0.02], requires_grad=True)
    loss = torch.sum((fit_render({"offset": offset}, BATCH) - distinct)
                     ** 2) / distinct.numel()
    grad, = torch.autograd.grad(loss, offset)
    want = (offset - 0.3 * grad).detach().numpy()
    loss = float(loss.detach())
    for r in ranks:
        np.testing.assert_allclose(r["distinct offset"], want, rtol=1e-6,
                                   atol=1e-7)
        assert abs(r["distinct loss"] - loss) <= 1e-6 * loss


def test_deferred_backward_under_sharding(ranks):
    _, _, rots, light, targets = deferred_scene()
    g_rots = _gathered([{"r": r["deferred"][0]} for r in ranks], "r")
    g_light = ranks[0]["deferred"][1]
    np.testing.assert_array_equal(g_light, ranks[1]["deferred"][1])
    want_rots, want_light = _grad_of(
        lambda r, l: deferred_loss(r, l, torch.as_tensor(targets)), rots,
        light)
    assert np.isfinite(g_rots).all() and np.isfinite(g_light).all()
    assert np.abs(want_light).sum() > 1e-4
    np.testing.assert_allclose(g_rots, want_rots, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_light, want_light, rtol=1e-5, atol=1e-6)
    assert (np.abs(g_rots).sum(axis=1) > 0).all()


def test_failing_rank_raises():
    with pytest.raises(ValueError, match="rank 1 fails on purpose"):
        launch.run_ranks(WORLD, _raise_on_rank_one, backend="gloo",
                         device="cpu")


def test_exiting_rank_raises():
    with pytest.raises(SystemExit) as exited:
        launch.run_ranks(WORLD, _exit_on_rank_one, backend="gloo",
                         device="cpu")
    assert exited.value.code == 3


def test_ranks_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_ranks(WORLD, _raise_on_rank_one)


@pytest.mark.parametrize("module", ["sharding", "face_sharding"])
def test_every_public_name_is_ported(module):
    import importlib
    theirs = importlib.import_module(f"dirt_tpu.parallel.{module}")
    ours = importlib.import_module(f"dirt_tpu_torch.parallel.{module}")
    public = [name for name, value in vars(theirs).items()
              if not name.startswith("_")
              and getattr(value, "__module__", theirs.__name__)
              == theirs.__name__ and not isinstance(value, type(np))]
    assert public and all(hasattr(ours, name) for name in public), public
