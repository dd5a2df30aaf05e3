"""A configuration brings its own mesh and entry point as new files: a
UV-mapped quad grid and a textured deferred step (the G-buffer's UV
channels sample a learnable texture through the port's
utils.textures), run to `correct` with no file of the benchmark edited;
and a cell whose mesh kind or entry has no module fails before set-up,
naming the file it looked for."""

import hashlib
import json
import shutil

import pytest
import torch

from bench_h100.harness import inputs as cell_inputs, runner, spec
from bench_h100.harness.program import Program, Spans

MESH = '''"""A flat grid of `quads` x `quads` squares of side `size` / `quads` in
the z = 0 plane, centred on the origin, with (u, v) in [0, 1] per
vertex."""

import numpy as np


def make(mesh):
    n, size = mesh["quads"], mesh["size"]
    ticks = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    x, y = np.meshgrid(ticks, ticks)
    vertices = np.stack([x, y, np.zeros_like(x)], -1).reshape(-1, 3)
    uvs = np.stack([(x - ticks[0]) / size, (ticks[-1] - y) / size],
                   -1).reshape(-1, 2)
    corner = (np.arange(n)[:, None] * (n + 1) + np.arange(n)).reshape(-1)
    a, b, c, d = corner, corner + 1, corner + n + 1, corner + n + 2
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)]).astype(np.int32)
    return {"vertices": vertices.astype(np.float32), "faces": faces,
            "uvs": uvs.astype(np.float32)}
'''

ENTRY = '''"""rasterise_batch_deferred on a 3-channel G-buffer (mask, u, v): the
shader samples a learnable texture bilinearly at each pixel's (u, v)
through the port's utils.textures; the reference samples it in plain
PyTorch."""

import torch

from bench_h100.reference import autograd

LEAVES = ("texture",)
TEXELS = 16


def draw(config, num_vertices, generator, device):
    return dict(
        texture=torch.rand((TEXELS, TEXELS, 3), generator=generator,
                           device=device),
        background=torch.zeros(config["batch"], config["height"],
                               config["width"], 3, device=device))


def scene(clip, leaves, inputs):
    uvs = inputs.mesh["uvs"].expand(clip.shape[0], -1, -1)
    return torch.cat([torch.ones_like(clip[..., :1]), uvs], -1).contiguous()


def rasterise(port, background, clip, values, faces, shade):
    return port.rasterise_batch_deferred(background, clip, values, faces,
                                         shade)


def shade(gbuffer, leaves):
    from dirt_tpu_torch.utils import textures
    texture = leaves["texture"]
    indices = textures.uvs_to_pixel_indices(gbuffer[..., 1:3],
                                            (TEXELS, TEXELS), mode="clamp")
    return textures.sample_texture(texture, indices) * gbuffer[..., :1]


def plain_shade(gbuffer, texture):
    uv = torch.maximum(gbuffer[..., 1:3], torch.zeros_like(gbuffer[..., 1:3]))
    indices = torch.minimum(uv, torch.ones_like(uv)).flip(-1) * TEXELS
    floor = torch.floor(indices)
    frac = indices - floor
    r0 = floor[..., 0].long().clamp(0, TEXELS - 1)
    c0 = floor[..., 1].long().clamp(0, TEXELS - 1)
    r1, c1 = (r0 + 1).clamp(0, TEXELS - 1), (c0 + 1).clamp(0, TEXELS - 1)
    fr, fc = frac[..., :1], frac[..., 1:]
    texels = (texture[r0, c0] * (1. - fc) * (1. - fr)
              + texture[r0, c1] * fc * (1. - fr)
              + texture[r1, c0] * (1. - fc) * fr
              + texture[r1, c1] * fc * fr)
    return texels * gbuffer[..., :1]


def reference(clip, leaves, inputs):
    return autograd.rasterise_batch_deferred(
        leaves["background"], clip, scene(clip, leaves, inputs),
        inputs.faces, lambda gbuffer: plain_shade(gbuffer, leaves["texture"]))
'''

CONFIG = {"name": "quad8_b2_24", "source": "a test",
          "mesh": {"kind": "quad_grid", "size": 2.0, "quads": 8},
          "faces": 128, "batch": 2, "height": 24, "width": 24, "channels": 3,
          "reduced": []}
TRAFFIC = {"why": "a test", "entry": "textured", "half_width": 0.08,
           "distance": 3.0, "pool": 4, "kept_entries": 2, "trace_steps": 2}
CELL = "quad8_b2_24.textured"


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _bench_with_the_toy(tmp_path, config=CONFIG, traffic=TRAFFIC):
    """A copy of the benchmark's folder and BENCHMARK.json with the toy
    cell added as new files and entries; (root, bench_dir)."""
    bench_dir = tmp_path / "bench_h100"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    (bench_dir / "meshes" / "quad_grid.py").write_text(MESH)
    (bench_dir / "entries" / "textured.py").write_text(ENTRY)
    (bench_dir / "configs" / "quad8_b2_24.json").write_text(
        json.dumps(config))
    (bench_dir / "traffic" / "textured.json").write_text(json.dumps(traffic))
    (bench_dir / "checks" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"pixels": 1e-5, "grads": 1e-4, "loss": 1e-6}}))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "quad8_b2_24", "source": "a test",
                             "file": "bench_h100/configs/quad8_b2_24.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "quad8_b2_24",
                               "traffic": "textured", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(bench_dir)
    assert all(after[path] == digest for path, digest in before.items())
    return tmp_path, bench_dir


def test_a_new_mesh_and_entry_point_are_new_files(tmp_path, blocks_on_cpu):
    root, bench_dir = _bench_with_the_toy(tmp_path)
    cell = spec.load_cell(CELL, root=root, bench_dir=bench_dir)
    result = runner.measure(cell, 2 ** 31 + 17, 0.2, 0, "cpu", 0.0)
    assert result.correct, result.numbers
    assert result.steps >= 1 and result.failed == 0

    data = cell_inputs.make_inputs(cell, 3, "cpu")
    assert data.background.shape == (2, 24, 24, 3)
    assert set(data.mesh) == {"uvs"} and set(data.tensors) == {"texture"}
    program = Program(cell, data, {}, Spans())
    program.step(0)
    grad = program.leaves["texture"].grad
    assert grad is not None and torch.isfinite(grad).all()
    assert float(grad.abs().max()) > 0

    harness = bench_dir / "harness"
    for path, digest in _digests(harness).items():
        ours = spec.BENCH_DIR / "harness" / path
        assert hashlib.sha256(ours.read_bytes()).hexdigest() == digest, path


@pytest.mark.parametrize("missing", ["mesh", "entry"])
def test_a_missing_module_fails_before_set_up(tmp_path, missing):
    config, traffic = dict(CONFIG), dict(TRAFFIC)
    if missing == "mesh":
        config["mesh"] = dict(CONFIG["mesh"], kind="nosuch")
        want = "meshes/nosuch.py"
    else:
        traffic["entry"] = "nosuch"
        want = "entries/nosuch.py"
    root, bench_dir = _bench_with_the_toy(tmp_path, config, traffic)
    with pytest.raises(FileNotFoundError, match=want):
        spec.load_cell(CELL, root=root, bench_dir=bench_dir)
