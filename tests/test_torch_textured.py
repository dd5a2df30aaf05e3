"""The textured multi-view fit on the CPU: the port's texture sampler as
one autograd Function (utils/textures) against the composition it
replaced, its spans and counter, the benchmark's UV cylinder, the
textured entry point against the plain reference
(bench_h100/reference/texture.py) on the blocks path, and the sampler
metrics' byte and operation counts and readers.  No jax."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100.harness import check, inputs as cell_inputs, spec
from bench_h100.harness.program import Program, Spans
from bench_h100.meshes.cylinder import make_cylinder
from bench_h100.reference import texture as plain
from dirt_tpu_torch import lighting
from dirt_tpu_torch.utils import profiling, textures

CELL = "uvcyl65536_b32_512_tex1024.textured"
MESH = {"radius": 0.5, "height": 1.0, "end_offset": 0.1, "bevel": 0.2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh, empty span recorder for the test."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())


def _module(folder, name):
    return spec.load_module(spec.BENCH_DIR / folder / f"{name}.py",
                            "test_textured_")


# -- the sampler ------------------------------------------------------------

def composed_sample(texture, indices, mode):
    """The sampler as it was before the Function: index_select gathers
    composed under autograd (the oracle)."""
    h, w = texture.shape[0], texture.shape[1]
    texels = texture.reshape(h * w, -1)

    def at(r, c):
        flat = (r * w + c).reshape(-1)
        return texels.index_select(0, flat).reshape(
            r.shape + texture.shape[2:])

    if mode == 'nearest':
        idx = indices.to(torch.int64)
        return at(idx[..., 0].clamp(0, h - 1), idx[..., 1].clamp(0, w - 1))
    floor_indices = torch.floor(indices)
    frac = indices - floor_indices
    r0 = floor_indices[..., 0].to(torch.int64).clamp(0, h - 1)
    c0 = floor_indices[..., 1].to(torch.int64).clamp(0, w - 1)
    r1 = (r0 + 1).clamp(0, h - 1)
    c1 = (c0 + 1).clamp(0, w - 1)
    fr = frac[..., :1]
    fc = frac[..., 1:]
    return (at(r0, c0) * (1. - fc) * (1. - fr)
            + at(r0, c1) * fc * (1. - fr)
            + at(r1, c0) * (1. - fc) * fr
            + at(r1, c1) * fc * fr)


def _uvs(h, w, seed):
    """(u, v) at the texture's corner and edge texels, at whole indices
    (fraction 0) and just under them (fraction near 1), outside [0, 1]
    and at random: [3, 8, 2]."""
    near_one = 1. - 2. ** -12
    rows = [0., h - 1., h - 1. + near_one, 2., 2. + near_one, 0., h / 2.,
            h - 1.]
    cols = [0., w - 1., w - 1. + near_one, 3. + near_one, 3., w - 1., 0.,
            w / 2.]
    edges = np.stack([np.array(cols) / w, np.array(rows) / h], -1)
    rng = np.random.RandomState(seed)
    return torch.as_tensor(np.stack([
        edges, edges + [[1., -1.]],
        rng.uniform(-0.5, 1.5, size=(8, 2))]).astype(np.float32))


# The texture gradient sums each texel's terms in another order than the
# composition (one buffer, corner by corner, against four buffers added),
# and the index gradient adds its four corner terms in another order than
# autograd's accumulation: float32 rounding of sums of a few terms, a few
# ulps of the largest gradient.
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("addressing", ["repeat", "clamp"])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_the_function_against_the_composition(mode, addressing):
    h, w = 5, 7
    rng = np.random.RandomState(3)
    texture = torch.as_tensor(rng.uniform(size=(h, w, 3)).astype(np.float32))
    uvs = _uvs(h, w, 4)
    weights = torch.as_tensor(rng.uniform(0.5, 1.5, size=(3, 8, 3)).astype(
        np.float32))
    got = {}
    for name, sample in (("function", textures.sample_texture),
                         ("composition", composed_sample)):
        leaf_texture = texture.clone().requires_grad_(True)
        leaf_uvs = uvs.clone().requires_grad_(True)
        indices = textures.uvs_to_pixel_indices(leaf_uvs, (h, w), addressing)
        out = sample(leaf_texture, indices, mode)
        (out * weights).sum().backward()
        got[name] = (out.detach(), leaf_texture.grad, leaf_uvs.grad)
    (out, grad_texture, grad_uvs), (want, want_texture, want_uvs) = (
        got["function"], got["composition"])
    assert torch.equal(out, want)
    scale = float(want_texture.abs().max())
    assert float((grad_texture - want_texture).abs().max()) <= (
        GRAD_RTOL * scale)
    if mode == "nearest":
        assert grad_uvs is None and want_uvs is None
    else:
        scale = float(want_uvs.abs().max())
        assert scale > 0
        assert float((grad_uvs - want_uvs).abs().max()) <= GRAD_RTOL * scale


def test_only_the_indices_take_a_gradient():
    """A fixed texture: the index gradient alone, as the composition's."""
    texture = torch.rand(4, 6, 2, generator=torch.Generator().manual_seed(1))
    indices = torch.tensor([[0.25, 4.5], [3.5, 5.75], [1.0, 2.0]])
    got, want = (indices.clone().requires_grad_(True) for _ in range(2))
    textures.sample_texture(texture, got).sum().backward()
    composed_sample(texture, want, "bilinear").sum().backward()
    assert torch.allclose(got.grad, want.grad, rtol=0, atol=GRAD_RTOL)
    out = textures.sample_texture(texture, indices.requires_grad_(True),
                                  "nearest")
    assert not out.requires_grad


def test_spans_and_the_texel_counter_under_a_profiler(recorder):
    texture = torch.rand(4, 4, 3).requires_grad_(True)
    # Corners (0, 0), (0, 1), (1, 0), (1, 1) twice; then row 2, column 3,
    # whose column and row neighbours clamp onto it: texels 11 and 15.
    indices = torch.tensor([[0.5, 0.5], [0.25, 0.75], [2.0, 3.0]],
                           requires_grad=True)
    textures.sample_texture(texture, indices).sum().backward()
    assert profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        textures.sample_texture(texture, indices).sum().backward()
    spans = profiling.records()
    assert [r.name for r in spans] == ["dirt.texture.sample",
                                       "dirt.texture.sample_grad"]
    assert spans[0].counters == {}
    assert spans[1].counters == {"texture.texels_touched": 6}
    assert all(r.stream_ms is None for r in spans)


def test_no_counter_without_a_texture_gradient(recorder):
    indices = torch.tensor([[0.5, 0.5]], requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        textures.sample_texture(torch.rand(4, 4, 3), indices).sum().backward()
    assert [r.counters for r in profiling.records()] == [{}, {}]


def test_the_reference_sampler_and_normals_match_the_port():
    """bench_h100/reference/texture.py, written apart from the port, gives
    the port's samples and normals: the same blend on the same texels, and
    cross products summed in another order (a few ulps)."""
    rng = np.random.RandomState(5)
    texture = torch.as_tensor(rng.uniform(size=(6, 9, 3)).astype(np.float32))
    uvs = torch.as_tensor(rng.uniform(-1, 2, size=(4, 5, 2)).astype(
        np.float32))
    indices = textures.uvs_to_pixel_indices(uvs, (6, 9))
    assert torch.equal(plain.repeat_indices(uvs, 6, 9), indices)
    assert torch.equal(plain.sample_bilinear(texture, indices),
                       textures.sample_texture(texture, indices))
    vertices, faces = make_cylinder(0.5, 1.0, 0.1, 0.2, 16)
    vertices = torch.as_tensor(vertices + 0.05 * rng.randn(
        2, *vertices.shape).astype(np.float32))
    faces = torch.as_tensor(faces)
    assert torch.allclose(plain.vertex_normals(vertices, faces),
                          lighting.vertex_normals(vertices, faces),
                          rtol=0, atol=1e-6)


# -- the UV cylinder --------------------------------------------------------

def test_the_uv_cylinder_is_the_cylinder_with_an_atlas():
    segments = 32
    out = _module("meshes", "uv_cylinder").make(dict(MESH,
                                                     segments=segments))
    vertices, faces, uvs = out["vertices"], out["faces"], out["uvs"]
    want_vertices, want_faces = make_cylinder(*MESH.values(), segments)
    assert faces.shape == (256, 3) and faces.dtype == np.int32
    assert uvs.shape == (len(vertices), 2) and uvs.dtype == np.float32
    assert np.array_equal(vertices[faces], want_vertices[want_faces])
    assert uvs.min() == 0. and uvs.max() == 1.
    u = uvs[faces][..., 0]
    assert (u.max(1) - u.min(1)).max() <= 1. / segments
    # Every vertex is used, and each apex copy by one fan face alone.
    assert np.array_equal(np.unique(faces), np.arange(len(vertices)))
    apexes = np.bincount(faces.reshape(-1))[4 * (segments + 1):]
    assert len(apexes) == 2 * segments and (apexes == 1).all()


# -- the textured entry point against the reference -------------------------

def _small_cell():
    """The cell's files at a CPU test's size: 32 segments, 2 views of 32 x
    32, a 16 x 16 texture, 4 poses."""
    cell = copy.deepcopy(spec.load_cell(CELL))
    cell.config.update(batch=2, height=32, width=32)
    cell.config["mesh"]["segments"] = 32
    cell.config["texture"] = dict(cell.config["texture"], height=16,
                                  width=16)
    cell.traffic.update(pool=4, kept_entries=2, trace_steps=2)
    return cell


# Pixels: the normals are summed in another order on each side (a few
# ulps), and the shader's Lambert is a matrix product in the port and a
# sum in the reference.  Gradients, over each leaf's largest: the
# scatters' and the rasteriser's gradient sums in another order.
PIXEL_TOL = 1e-6
LEAF_RTOL = 1e-5
LOSS_RTOL = 1e-6


def test_the_textured_step_against_the_reference(monkeypatch):
    monkeypatch.setenv("DIRT_TPU_TORCH_BACKEND", "blocks")
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "blocks")
    cell = _small_cell()
    data = cell_inputs.make_inputs(cell, 2 ** 31 + 99, "cpu")
    assert set(data.mesh) == {"uvs"}
    assert set(data.tensors) == {"texture", "light"}
    assert data.tensors["texture"].shape == (16, 16, 3)
    assert data.background.shape == (2, 32, 32, 6)
    kept = {0: 1, 3: 0}
    program = Program(cell, data, kept, Spans())
    for k in (0, 3):
        program.step(k)
        program.keep()
    want = check.reference_outputs(cell, data, kept)
    for entry, ref in want.items():
        got = program.outputs[entry]
        assert float((got["pixels"] - ref["pixels"]).abs().max()) <= (
            PIXEL_TOL)
        assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        assert set(ref["grads"]) == {"texture", "light", "rotations",
                                     "background"}
        for name, grad in ref["grads"].items():
            scale = float(grad.abs().max())
            assert scale > 0, name
            gap = float((got["grads"][name] - grad).abs().max())
            assert gap <= LEAF_RTOL * scale, (name, gap / scale)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_the_control_fails_the_cells_limits(seed):
    """The reference on TF32 operands in the program's place fails the
    checks file's limits, at the CPU test's size too."""
    from bench_h100 import limits
    cell = _small_cell()
    values = limits.control_numbers(cell, seed, "cpu")
    assert not check.judge(values, cell.limits), values


# -- the sampler's metrics --------------------------------------------------

def test_the_roofline_counts_by_hand():
    roofline = _module("metrics", "texture.sample.roofline_pct")
    # 2 points, a 2 x 2 texture of 3 channels.  Forward: 2 x (2 + 3)
    # floats and 12 texture floats; 2 x (6 + 11 x 3) operations.
    assert roofline.sample_work(2, 4, 3) == (4 * 22, 78)
    # Backward: 2 x (3 + 2 + 2) floats and 12 gradient floats; 2 x (6 +
    # 32 x 3) operations.
    assert roofline.sample_grad_work(2, 4, 3) == (4 * 26, 204)
    # The bytes bound both halves: 48 bytes at 3.35e9 a ms.
    assert roofline.least_ms(2, 4, 3) == pytest.approx(
        4 * 22 / 3.35e9 + 4 * 26 / 3.35e9)


def _readings(monkeypatch, spans):
    """Readings of a traced run of 2 steps of 2 x 4 x 4 images and a 2 x 2
    x 3 texture whose port records are `spans` (name, stream ms,
    counters), each traced step's own, both profiles."""
    records = []
    for step in range(4):                    # two device-only, two host
        t = 100 * step
        records.append(SimpleNamespace(name="dirt.forward", start_ns=t,
                                       end_ns=t + 50, stream_ms=1.0,
                                       counters={}))
        records += [SimpleNamespace(name=name, start_ns=t + 60,
                                    end_ns=t + 70, stream_ms=ms,
                                    counters=dict(counters))
                    for name, ms, counters in spans]
    monkeypatch.setattr(profiling, "records", lambda: records)
    trace = SimpleNamespace(steps=2)
    cell = SimpleNamespace(config={"texture": {"height": 2, "width": 2,
                                               "channels": 3}})
    return SimpleNamespace(trace=trace, span_trace=trace, cell=cell,
                           batch=2, height=4, width=4)


def test_the_sampler_metrics_read_the_spans(monkeypatch):
    read = lambda name: spec.metric_reader(name)
    readings = _readings(monkeypatch, [
        ("dirt.texture.sample", 0.5, {}),
        ("dirt.texture.sample_grad", 1.5,
         {"texture.texels_touched": 4})])
    assert read("texture.sample.stream_ms")(readings) == 0.5
    assert read("texture.sample_grad.stream_ms")(readings) == 1.5
    roofline = _module("metrics", "texture.sample.roofline_pct")
    assert read("texture.sample.roofline_pct")(readings) == pytest.approx(
        100.0 * roofline.least_ms(32, 4, 3) / 2.0)
    # 8 fetches at each of 32 points in each of 2 steps, over 4 texels in
    # each step.
    assert read("texture.fetches_per_texel")(readings) == 8 * 32 * 2 / 8
    readings = _readings(monkeypatch, [])
    for name in ("texture.sample.stream_ms", "texture.sample_grad.stream_ms",
                 "texture.sample.roofline_pct", "texture.fetches_per_texel"):
        assert read(name)(readings) is None
