"""Structural checks of the PyTorch port that need no GPU.

* `import dirt_tpu_torch` must not import jax (the port runs where jax is
  not installed), and no module of the port imports jax, dirt_tpu or the
  repository's repro/ scripts.
* chip_smoke.py must fail, printing no result, where no CUDA device is
  available, and when it is run without the rest of the repository; the
  segment sum it times as the reductions' library form computes their
  function.
* Each kernel wrapper names the TPU kernel it replaces, and its CUDA source
  says so in its header; a kernel that replaces none says that instead.
* CPU tensors run the plain versions; tensors on any other non-CUDA device
  raise instead of falling back.
* The port reads six DIRT_TPU_TORCH_* environment variables, the
  gradient's choice in one module.
* Entry points given numpy inputs run on the card: without one they
  raise, unless the caller asks for the CPU with device="cpu" (the
  rasteriser's, matrices', lighting's, projection's, textures', a
  renderer model's and the face-sharded rasteriser's).
"""

import ast
import importlib.util
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "dirt_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_leaves_jax_out():
    code = ("import sys, dirt_tpu_torch, dirt_tpu_torch.ops.grad_blocks, "
            "dirt_tpu_torch.ops.forward_dense, dirt_tpu_torch.ops.grad_dense, "
            "dirt_tpu_torch.ops.forward_pallas, dirt_tpu_torch.ops.grad_mxu, "
            "dirt_tpu_torch.ops.dispatch, dirt_tpu_torch.devices, "
            "dirt_tpu_torch.repro.scalar_accum, "
            "dirt_tpu_torch.utils.convert, dirt_tpu_torch.utils.oracle, "
            "dirt_tpu_torch.lighting, dirt_tpu_torch.projection, "
            "dirt_tpu_torch.models, dirt_tpu_torch.utils.textures, "
            "dirt_tpu_torch.utils.profiling, dirt_tpu_torch.samples.simple, "
            "dirt_tpu_torch.samples.deferred, "
            "dirt_tpu_torch.samples.textured, dirt_tpu_torch.parallel, "
            "dirt_tpu_torch.parallel.sharding, "
            "dirt_tpu_torch.parallel.face_sharding, "
            "dirt_tpu_torch.parallel.launch, dirt_tpu_torch.parallel.dryrun; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   cwd=REPO, timeout=120)


def test_no_source_file_imports_jax():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert not name.split(".")[0] in ("jax", "dirt_tpu",
                                                  "repro"), (
                    f"{path.relative_to(REPO)} imports {name}")


def _environ_reads():
    """{name: {module}} of the DIRT_TPU_TORCH_* variables the port's
    source reads: os.environ.get(name, ...), os.getenv(name, ...) and
    os.environ[name] as a value."""
    is_environ = lambda n: (isinstance(n, ast.Attribute)
                            and n.attr == "environ"
                            and isinstance(n.value, ast.Name)
                            and n.value.id == "os")
    reads = {}
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            key = None
            if isinstance(node, ast.Call) and node.args and isinstance(
                    node.func, ast.Attribute) and (
                    (node.func.attr == "get" and is_environ(node.func.value))
                    or (node.func.attr == "getenv"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "os")):
                key = node.args[0]
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and is_environ(node.value)):
                key = node.slice
            if key is None:
                continue
            assert isinstance(key, ast.Constant), (
                f"{path.relative_to(REPO)}:{node.lineno} reads a variable "
                f"named at run time")
            if key.value.startswith("DIRT_TPU_TORCH_"):
                reads.setdefault(key.value[len("DIRT_TPU_TORCH_"):],
                                 set()).add(str(path.relative_to(PKG)))
    return reads


def test_environment_switches():
    """The port reads six DIRT_TPU_TORCH_* variables, each choosing what
    is computed or how much; switches whose settings compute the same
    values are module constants that tests set.  The gradient's choice
    is read in one module."""
    reads = _environ_reads()
    assert set(reads) == {"BACKEND", "BLOCKS_THRESHOLD", "GRAD_BACKEND",
                          "SLOTS_PER_IMAGE", "TILE_FACE_CAP",
                          "DIAGONAL_DILATION"}
    assert reads["GRAD_BACKEND"] == {"ops/dispatch.py"}


def _last_line(out):
    lines = [l for l in out.splitlines() if l.strip()]
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
    assert "cuda" in proc.stdout.lower()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_segment_sum_is_the_reduction():
    """chip_smoke times the segment sum as the library form of K3 and K9:
    summed per face, the dense reduction's rows must equal it."""
    from dirt_tpu_torch.ops import forward_blocks, grad_dense, prepass_fused
    smoke = _chip_smoke()
    background, clip, colors, faces, weights = smoke.bench_scene(
        2, 64, 16, "cpu")
    batch, height, width, channels = background.shape
    num_faces = faces.shape[1]
    pixels, aux = forward_blocks.rasterise_batch(background, clip, colors,
                                                 faces)
    planes = grad_dense.prepass_and_planes(pixels, weights, aux, "all")[0]
    got = smoke.segment_sum(planes, clip, faces, channels)

    th, tw, chunk = grad_dense.TILE_H, grad_dense.TILE_W, grad_dense.CHUNK
    table, face_ids, counts, sorted_orig = grad_dense.pack(
        clip, faces, height, width, th, tw, chunk)
    tiled = prepass_fused.tile_planes(planes, th, tw, planes.shape[1])
    rows = grad_dense.dense_grad_reduce_plain(table, face_ids, counts, tiled,
                                              channels, "all", chunk, height,
                                              width, th, tw)
    keys = sorted_orig.long() + torch.arange(batch)[:, None] * num_faces
    want = torch.zeros(batch * num_faces, rows.shape[-1]).index_add_(
        0, keys.reshape(-1), rows.reshape(-1, rows.shape[-1]))
    assert float(want.abs().max()) > 0
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1.)
    assert err <= 1e-5, err


def test_chip_smoke_masked_matmul_is_the_mxu_sums():
    """chip_smoke times the masks plus one float32 matmul as the library
    form of K10: it must give K10's rows (its plain version's) wherever a
    chunk is live."""
    from dirt_tpu_torch.ops import forward_blocks, grad_mxu
    smoke = _chip_smoke()
    background, clip, colors, faces, weights = smoke.bench_scene(
        2, 64, 16, "cpu")
    height, width = background.shape[1:3]
    pixels, aux = forward_blocks.rasterise_batch(background, clip, colors,
                                                 faces)
    ids, values, _ = grad_mxu.band_planes(pixels, weights, aux)
    chunk = 64
    face_ids, counts, _ = grad_mxu._pack_grad_bands(clip, faces, height,
                                                    width, 2, height // 16)
    got = smoke.masked_matmul(face_ids, ids, values, chunk)
    want = grad_mxu.mxu_grad_plain(face_ids, counts, ids,
                                   grad_mxu.split_bf16(values), chunk)
    got = got.reshape(want.shape)
    live = ((torch.arange(got.shape[1]) % 4)[None] * chunk
            < counts.repeat_interleave(4, dim=1))
    assert bool(live.any()) and float(want.abs().max()) > 0
    err = float((got[live] - want[live]).abs().max())
    assert err / max(float(want.abs().max()), 1.) <= 1e-5, err


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)


def test_kernels_name_what_they_replace():
    from dirt_tpu_torch.ops import (_cuda, forward_blocks, forward_dense,
                                    forward_pallas, grad_blocks, grad_dense,
                                    grad_mxu, prepass_fused)
    from dirt_tpu_torch.repro import scalar_accum
    del forward_blocks, forward_dense, forward_pallas, grad_blocks
    del grad_dense, grad_mxu, prepass_fused, scalar_accum
    assert sorted(_cuda.KERNELS) == ["build_runs", "dense_grad_reduce",
                                     "dense_sweep", "face_table",
                                     "grad_prepass",
                                     "grad_reduce", "hit_plane", "mxu_grad",
                                     "pallas_raster", "raster_sweep",
                                     "resident_sweep", "scalar_accum",
                                     "slot_grad_reduce", "slot_sweep"]
    assert sorted(k.source for k in _cuda.KERNELS.values()) == sorted(
        _cuda.SOURCES)
    for name, kernel in _cuda.KERNELS.items():
        assert kernel.source in _cuda.SOURCES
        header = (PKG / "csrc" / kernel.source).read_text()[:600]
        if kernel.replaces is None:
            # A kernel added where the JAX package has plain jnp says so.
            assert "Replaces no Pallas kernel" in header, name
            continue
        for ref in kernel.replaces.split(", "):
            path, line = ref.split(":")
            text = (REPO / path).read_text().splitlines()[int(line) - 1]
            assert text.startswith("def _"), (name, text)
            assert text[4:text.index("(")] in header, (name, ref)


@pytest.mark.parametrize("source", ["grad_reduce.cu", "slot_grad.cu",
                                    "grad_math.cuh", "dense_grad.cu",
                                    "mxu_grad.cu"])
def test_face_major_reductions_use_no_atomics(source):
    # K3's, K6's, K9's and K10's rows are deterministic by construction:
    # one owner per row and a fixed order, the lanes combined by a fixed
    # tree or butterfly.  No atomic intrinsic, and no PTX atom / red,
    # outside the comments.
    code = "\n".join(line.split("//")[0] for line in
                     (PKG / "csrc" / source).read_text().splitlines())
    assert "atomic" not in code.lower()
    assert not re.search(r"\b(atom|red)\.", code)


def test_cpu_runs_plain_and_other_devices_raise():
    from dirt_tpu_torch.ops import _cuda, forward_blocks
    t = torch.zeros(2, 3)
    assert _cuda.on_cuda(t) is False
    with pytest.raises(ValueError):
        _cuda.on_cuda(torch.zeros(2, 3, device="meta"))
    table = torch.zeros(1, 4, 36, device="meta")
    with pytest.raises(ValueError):
        forward_blocks.hit_blocks(table, (20, 21, 22, 23), 1, 4, 1, 1, 16,
                                  16, 0, 16, 16, 0)


def test_kernel_check_rejects_cpu_tensors():
    from dirt_tpu_torch.ops import _cuda
    with pytest.raises(ValueError):
        _cuda.check("x", torch.zeros(3), torch.float32)


def test_library_path_keys_on_sources():
    from dirt_tpu_torch.ops import _cuda
    path = _cuda.library_path()
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("libdirt_kernels_") and path.suffix == ".so"
    assert path == _cuda.library_path()


def _numpy_scene():
    rng = np.random.RandomState(0)
    v = rng.randn(10, 4).astype(np.float32)
    v[:, 3] = np.abs(v[:, 3]) + 0.5
    f = rng.randint(0, 10, size=(6, 3)).astype(np.int32)
    c = rng.uniform(size=(10, 3)).astype(np.float32)
    bg = rng.uniform(size=(8, 12, 3)).astype(np.float32)
    return bg, v, c, f


def _entry_points(bg, v, c, f, **kw):
    import dirt_tpu_torch
    from dirt_tpu_torch import lighting, matrices, models, projection
    from dirt_tpu_torch.utils import textures
    batch = lambda a: a[None]
    shade = lambda gb: gb * 2.0
    normals = c / np.linalg.norm(c, axis=-1, keepdims=True)
    light = np.array([0.6, -0.8, 0.], np.float32)
    return [
        lambda: dirt_tpu_torch.rasterise(bg, v, c, f, **kw),
        lambda: dirt_tpu_torch.rasterise_batch(*map(batch, (bg, v, c, f)),
                                               **kw),
        lambda: dirt_tpu_torch.rasterise_batch_with_aux(
            *map(batch, (bg, v, c, f)), **kw)[0],
        lambda: dirt_tpu_torch.rasterise_deferred(bg, v, c, f, shade, **kw),
        lambda: dirt_tpu_torch.rasterise_batch_deferred(
            *map(batch, (bg, v, c, f)), shade, **kw),
        lambda: dirt_tpu_torch.rasterise_grad_debug(bg, v, c, f, bg,
                                                    **kw)[1],
        lambda: matrices.perspective_projection(0.1, 20., 0.25, 1., **kw),
        lambda: matrices.compose(matrices.translation([1., 2., 3.], **kw),
                                 matrices.scale(np.ones(3), **kw)),
        lambda: matrices.rodrigues([0.1, 0.2, 0.3], **kw),
        lambda: lighting.vertex_normals(v, f, **kw),
        lambda: lighting.vertex_normals_pre_split(v, f, **kw),
        lambda: lighting.split_vertices_by_face(v, f, **kw)[0],
        lambda: lighting.diffuse_directional(normals, c, light, [1., 1., 1.],
                                             **kw),
        lambda: lighting.specular_directional(
            v[:, :3], normals, c, light, [1., 1., 1.], [0., 0., 3.], 6.,
            **kw),
        lambda: lighting.diffuse_point(v[:, :3], normals, c, [0., 2., 0.],
                                       [1., 1., 1.], **kw),
        lambda: projection.unproject_pixels_to_rays(
            bg[..., :2] * 10., np.eye(4, dtype=np.float32), [12, 8], **kw)[1],
        lambda: textures.uvs_to_pixel_indices(c[:, :2], (8, 12), **kw),
        lambda: textures.sample_texture(bg, c[:, :2] * 8., **kw),
        lambda: models.GouraudRenderer(12, 8).render(
            v[:, :3], f, c, [0., 0.5, 0.], **kw),
    ]


ENTRY_POINTS = 19


def test_entry_point_cases_are_counted():
    assert len(_entry_points(*_numpy_scene())) == ENTRY_POINTS


@pytest.mark.parametrize("entry", range(ENTRY_POINTS))
def test_numpy_inputs_go_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    call = _entry_points(*_numpy_scene())[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", range(ENTRY_POINTS))
def test_numpy_inputs_run_on_the_cpu_when_asked(entry):
    out = _entry_points(*_numpy_scene(), device="cpu")[entry]()
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


def test_tensors_decide_the_device():
    from dirt_tpu_torch.devices import input_device
    t = torch.zeros(2)
    assert input_device([np.zeros(2), t]) == torch.device("cpu")
    assert input_device([t], "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        input_device([t, torch.zeros(2, device="meta")])
    with pytest.raises(ValueError):
        input_device([t], "cuda")


def _face_sharded_entry(device):
    """The face-sharded rasteriser on numpy inputs, in a one-rank group."""
    from dirt_tpu_torch.parallel import face_sharding
    mesh = face_sharding.make_face_mesh(device_type="cpu")
    bg, v, c, f = (a[None] for a in _numpy_scene())
    return face_sharding.rasterise_batch_face_sharded(mesh, bg, v, c, f,
                                                      device=device)


def test_face_sharded_numpy_inputs_go_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from dirt_tpu_torch.parallel import launch
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_ranks(1, _face_sharded_entry, (None,), backend="gloo",
                         device="cpu")


def test_face_sharded_numpy_inputs_run_on_the_cpu_when_asked():
    from dirt_tpu_torch.parallel import launch
    out, = launch.run_ranks(1, _face_sharded_entry, ("cpu",),
                            backend="gloo", device="cpu")
    assert out.device.type == "cpu"
    assert bool(torch.isfinite(out).all())
