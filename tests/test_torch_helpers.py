"""dirt_tpu_torch's helper modules (lighting, projection, utils/textures)
against dirt_tpu's, on the CPU.

The same seeded numpy inputs, batched and unbatched, go through both
packages.  Values must agree within max |a - b| / max(max |a|, 1) <= 1e-6
(float32 arithmetic in another order), and the gradient of sum(out *
weights) by jax.grad and by autograd within 1e-5 on the same scale.  The
tie cases pin the gradients where JAX and PyTorch differ by default --
|x| at 0 (jnp.abs: 1, torch.abs: 0), max(x, 0) and clip at a bound
(jnp: 0.5, clamp: 1) -- to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu import lighting as jlighting
from dirt_tpu import matrices as jmatrices
from dirt_tpu import projection as jprojection
from dirt_tpu.utils import meshes as jmeshes
from dirt_tpu.utils import textures as jtextures
from dirt_tpu_torch import lighting, projection
from dirt_tpu_torch.utils import textures


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


VALUE_TOL = 1e-6
GRAD_TOL = 1e-5


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (name, err)


def _compare(jfn, tfn, arrays, grad_args, seed=0):
    """Values of jfn(*arrays) and tfn(*arrays) (numpy in, both packages),
    then the gradients of sum(out * w), w seeded, wrt arrays[i] for i in
    grad_args.  Returns the port's gradients."""
    want = jfn(*[jnp.asarray(a) for a in arrays])
    got = tfn(*[torch.as_tensor(a) for a in arrays])
    _close(got, want, VALUE_TOL, "values")
    w = np.random.RandomState(seed).uniform(
        0.5, 1.5, size=np.shape(want)).astype(np.float32)
    want_grads = jax.grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(grad_args))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [torch.tensor(a, requires_grad=i in grad_args)
              for i, a in enumerate(arrays)]
    (tfn(*leaves) * torch.as_tensor(w)).sum().backward()
    for i, want_grad in zip(grad_args, want_grads):
        _close(leaves[i].grad, want_grad, GRAD_TOL, f"grad of argument {i}")
    return [leaves[i].grad for i in grad_args]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _mesh(batch, seed=0):
    """The bench's cylinder (no zero-area faces), its vertices jittered
    per batch entry; [*batch, V, 3] and faces [F, 3]."""
    v, f = jmeshes.make_cylinder(0.5, 1.0, 0.1, 0.2, 8)
    rng = np.random.RandomState(seed)
    v = v + 0.05 * rng.randn(*batch, *v.shape).astype(np.float32)
    return v.astype(np.float32), f


BATCHES = [(), (2,)]


# -- lighting --------------------------------------------------------------

@pytest.mark.parametrize("batch", BATCHES)
def test_vertex_normals(batch):
    v, f = _mesh(batch)
    _compare(lambda v: jlighting.vertex_normals(v, f),
             lambda v: lighting.vertex_normals(v, f), [v], [0])


@pytest.mark.parametrize("batch", BATCHES)
def test_vertex_normals_drop_w(batch):
    v, f = _mesh(batch, seed=1)
    v4 = np.concatenate([v, np.full(v.shape[:-1] + (1,), 2., np.float32)],
                        -1)
    _compare(lambda v: jlighting.vertex_normals(v, f),
             lambda v: lighting.vertex_normals(v, f), [v4], [0])


@pytest.mark.parametrize("batch", BATCHES)
def test_split_and_pre_split_normals(batch):
    v, f = _mesh(batch, seed=2)
    jv, jf = jlighting.split_vertices_by_face(v, f)
    tv, tf = lighting.split_vertices_by_face(v, f, device="cpu")
    _close(tv, jv, 0.0, "split vertices")
    assert tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    split_faces = np.asarray(jf)
    _compare(lambda v: jlighting.vertex_normals_pre_split(
                 jlighting.split_vertices_by_face(v, f)[0], split_faces),
             lambda v: lighting.vertex_normals_pre_split(
                 lighting.split_vertices_by_face(v, f)[0], split_faces),
             [v], [0])


def test_pre_split_leaves_unreferenced_vertices_zero():
    v, f = _mesh((), seed=3)
    v, f = jlighting.split_vertices_by_face(v, f)
    v = np.concatenate([np.asarray(v), np.ones((2, 3), np.float32)])
    got = lighting.vertex_normals_pre_split(v, np.asarray(f), device="cpu")
    _close(got, jlighting.vertex_normals_pre_split(v, f), VALUE_TOL)
    assert float(got[-2:].abs().max()) == 0.0


def _shading_inputs(batch, seed, count=40, channels=3):
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        positions=f32(rng.randn(*batch, count, 3)),
        normals=_unit(rng.randn(*batch, count, 3)),
        colors=f32(rng.uniform(0.1, 1., size=(*batch, count, channels))),
        light=_unit(rng.randn(*batch, 3)),
        light_color=f32(rng.uniform(0.2, 1., size=(*batch, channels))),
        camera=f32(rng.randn(*batch, 3) + [0., 0., 4.]),
        shininess=f32(rng.uniform(2., 8., size=batch)))


@pytest.mark.parametrize("double_sided", [True, False])
@pytest.mark.parametrize("batch", BATCHES)
def test_diffuse_directional(batch, double_sided):
    x = _shading_inputs(batch, 4)
    _compare(
        lambda *a: jlighting.diffuse_directional(*a, double_sided),
        lambda *a: lighting.diffuse_directional(*a, double_sided),
        [x["normals"], x["colors"], x["light"], x["light_color"]],
        [0, 1, 2, 3])


@pytest.mark.parametrize("double_sided", [True, False])
@pytest.mark.parametrize("batch", BATCHES)
def test_specular_directional(batch, double_sided):
    x = _shading_inputs(batch, 5)
    _compare(
        lambda *a: jlighting.specular_directional(*a, double_sided),
        lambda *a: lighting.specular_directional(*a, double_sided),
        [x["positions"], x["normals"], x["colors"], x["light"],
         x["light_color"], x["camera"], x["shininess"]],
        [0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("double_sided", [True, False])
@pytest.mark.parametrize("batch", BATCHES)
def test_diffuse_point(batch, double_sided):
    x = _shading_inputs(batch, 6)
    _compare(
        lambda *a: jlighting.diffuse_point(*a, double_sided),
        lambda *a: lighting.diffuse_point(*a, double_sided),
        [x["positions"], x["normals"], x["colors"], x["camera"],
         x["light_color"]], [0, 1, 2, 3, 4])


# The cube's top and bottom normals (0, +-1, 0) under the light (1, 0, 0):
# n . l is exactly 0.
TIE_NORMALS = np.array([[0., 1., 0.], [0., -1., 0.], [1., 0., 0.],
                        [-1., 0., 0.]], np.float32)
TIE_LIGHT = np.array([1., 0., 0.], np.float32)


@pytest.mark.parametrize("double_sided", [True, False])
def test_diffuse_tie_gradients_follow_jax(double_sided):
    colors = np.full((4, 3), 0.7, np.float32)
    grads = _compare(
        lambda n, l: jlighting.diffuse_directional(
            n, colors, l, jnp.ones(3), double_sided),
        lambda n, l: lighting.diffuse_directional(
            n, colors, l, torch.ones(3), double_sided),
        [TIE_NORMALS, TIE_LIGHT], [0, 1])
    # At the tie |x| passes the full gradient (torch.abs would pass none)
    # and max(x, 0) half of it (clamp_min would pass all).
    tie_grad = float(grads[0][0, 0])
    assert tie_grad != 0.0
    w = np.random.RandomState(0).uniform(0.5, 1.5, size=(4, 3)).astype(
        np.float32)
    full = -float((w[0] * colors[0]).sum())
    assert tie_grad == pytest.approx(full if double_sided else full / 2,
                                     rel=1e-6)


def test_point_tie_gradients_follow_jax():
    # The light in the plane of the normals: n . d is exactly 0.
    positions = np.array([[1., 0., 0.], [1., 0., 0.]], np.float32)
    normals = np.array([[0., 1., 0.], [0., 0., 1.]], np.float32)
    colors = np.ones((2, 3), np.float32)
    for double_sided in (True, False):
        _compare(
            lambda p, n: jlighting.diffuse_point(
                p, n, colors, jnp.zeros(3), jnp.ones(3), double_sided),
            lambda p, n: lighting.diffuse_point(
                p, n, colors, torch.zeros(3), torch.ones(3), double_sided),
            [positions, normals], [0, 1])


# -- projection ------------------------------------------------------------

def _clip_to_world(batch, seed):
    """inv(view @ projection) of seeded cameras, the documented input."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(int(np.prod(batch))):
        view = jmatrices.compose(
            jmatrices.translation(jnp.asarray(
                rng.uniform(-1., 1., 3) + [0., 0., -4.], jnp.float32)),
            jmatrices.rodrigues(jnp.asarray(rng.uniform(-0.5, 0.5, 3),
                                            jnp.float32)))
        proj = jmatrices.perspective_projection(0.1, 20., 0.1, 0.75)
        out.append(np.linalg.inv(np.asarray(view @ proj)))
    return np.stack(out).reshape(batch + (4, 4)).astype(np.float32)


@pytest.mark.parametrize("batch, pixel_dims", [((), (6, 5)), ((), (7,)),
                                                ((2,), (4, 3)), ((3,), (5,))])
def test_unproject_pixels_to_rays(batch, pixel_dims):
    rng = np.random.RandomState(7)
    pixels = rng.uniform(0., 60., size=(*batch, *pixel_dims, 2)).astype(
        np.float32)
    matrix = _clip_to_world(batch, 8)
    size = np.broadcast_to(np.array([64, 48], np.int32), batch + (2,))
    for part in (0, 1):
        _compare(
            lambda p, m: jprojection.unproject_pixels_to_rays(p, m, size)[
                part],
            lambda p, m: projection.unproject_pixels_to_rays(p, m, size)[
                part],
            [pixels, matrix], [0, 1])


# -- textures --------------------------------------------------------------

# u and v on both sides of [0, 1], and exactly on its bounds (the clamp's
# ties).
UVS = np.array([[0.25, 0.5], [1.75, -0.3], [-1.2, 2.4], [0.0, 1.0],
                [1.0, 0.0], [0.999, 0.001]], np.float32)


@pytest.mark.parametrize("mode", ["repeat", "clamp"])
def test_uvs_to_pixel_indices(mode):
    _compare(lambda uv: jtextures.uvs_to_pixel_indices(uv, (16, 12), mode),
             lambda uv: textures.uvs_to_pixel_indices(uv, (16, 12), mode),
             [UVS], [0])


def test_clamp_tie_gradients_follow_jax():
    got = _compare(
        lambda uv: jtextures.uvs_to_pixel_indices(uv, (16, 12), "clamp"),
        lambda uv: textures.uvs_to_pixel_indices(uv, (16, 12), "clamp"),
        [UVS[3:5]], [0])[0]
    w = np.random.RandomState(0).uniform(0.5, 1.5, size=(2, 2)).astype(
        np.float32)
    # uv (0, 1) -> (row, col) = (1 * 16, 0 * 12): half the gradient at each
    # bound.
    assert float(got[0, 0]) == pytest.approx(0.5 * 12 * w[0, 1], rel=1e-6)
    assert float(got[0, 1]) == pytest.approx(0.5 * 16 * w[0, 0], rel=1e-6)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("index_shape", [(9,), (4, 5)])
def test_sample_texture(mode, index_shape):
    rng = np.random.RandomState(9)
    texture = rng.uniform(size=(7, 6, 3)).astype(np.float32)
    # Inside, on the edge and past the edge (the clamped reads).
    indices = rng.uniform(-1.5, 8.5, size=index_shape + (2,)).astype(
        np.float32)
    indices.reshape(-1, 2)[:2] = [[3.0, 2.0], [6.0, 5.0]]
    grad_args = [0, 1] if mode == "bilinear" else [0]
    _compare(lambda t, i: jtextures.sample_texture(t, i, mode),
             lambda t, i: textures.sample_texture(t, i, mode),
             [texture, indices], grad_args)


def test_sample_texture_of_uvs():
    """The textured renderer's shader: uvs -> indices -> bilinear samples,
    differentiable wrt the texture and the uvs."""
    rng = np.random.RandomState(10)
    texture = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    uvs = rng.uniform(-0.5, 1.5, size=(5, 4, 2)).astype(np.float32)
    _compare(
        lambda t, uv: jtextures.sample_texture(
            t, jtextures.uvs_to_pixel_indices(uv, t.shape[:2])),
        lambda t, uv: textures.sample_texture(
            t, textures.uvs_to_pixel_indices(uv, t.shape[:2])),
        [texture, uvs], [0, 1])


def test_unknown_modes_raise():
    with pytest.raises(NotImplementedError):
        textures.uvs_to_pixel_indices(torch.zeros(2), (4, 4), "mirror")
    with pytest.raises(NotImplementedError):
        textures.sample_texture(torch.zeros(4, 4, 3), torch.zeros(2),
                                "cubic")


# -- utils/profiling ------------------------------------------------------

# The most a span's time.time_ns() stamp may stray outside a profiler
# range it was taken in, on the trace's clock (microseconds): the two
# clocks' rounding (time.time_ns() stamps taken inside ranges lie 3.5 us
# or more inside them).
CLOCK_US = 20.0


def test_profiling_trace_annotate_and_sections(tmp_path):
    """trace() writes one Chrome trace with the port's spans of its
    session merged in, on their own track and on the profiler's clock: the
    forward's entry span lies inside a record_function range around the
    same call, to within the two clocks' rounding (CLOCK_US)."""
    import json
    import dirt_tpu_torch
    from dirt_tpu_torch.utils import profiling
    verts, faces = _mesh(())
    clip = torch.cat([torch.as_tensor(verts) * 0.5,
                      torch.ones(len(verts), 1)], 1)[None]
    colors = torch.ones_like(clip[..., :3])
    faces = torch.as_tensor(faces, dtype=torch.int32)[None]
    render = lambda: dirt_tpu_torch.rasterise_batch(
        torch.zeros(1, 16, 16, 3), clip, colors, faces, backend="blocks")
    render()                                # warm, and off: no record
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("warm"):
            pass                            # a session's first range is slow
        with torch.profiler.record_function("dirt_section"):
            render()
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    outer, = [e for e in events if e.get("name") == "dirt_section"
              and e.get("cat") == "user_annotation"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    assert {e["name"] for e in spans} >= {"dirt.forward",
                                          "dirt.forward.sweep"}
    assert {e["pid"] for e in spans} == {profiling.SPAN_PID}
    entry, = [e for e in spans if e["name"] == "dirt.forward"]
    # How far inside depends on the host: a preemption or a collection
    # between the range's entry and the span's widens the gap, unbounded
    # under a loaded suite.  Past the range's ends only rounding remains.
    assert entry["ts"] >= outer["ts"] - CLOCK_US
    assert entry["ts"] + entry["dur"] <= outer["ts"] + outer["dur"] + CLOCK_US
    sweep, = [e for e in spans if e["name"] == "dirt.forward.sweep"]
    assert sweep["args"]["parent"] == "dirt.forward"
    runs, = [e for e in spans if e["name"] == "dirt.forward.runs"]
    assert runs["args"]["forward.dropped"] == 0
    assert runs["args"]["forward.visits"] > 0
