"""Structural checks of the PyTorch port that need no GPU.

* `import dirt_tpu_torch` must not import jax (the port runs where jax is
  not installed).
* chip_smoke.py must fail, printing no result, where no CUDA device is
  available, and when it is run without the rest of the repository.
* Each kernel wrapper names the TPU kernel it replaces, and its CUDA source
  says so in its header.
* CPU tensors run the plain versions; tensors on any other non-CUDA device
  raise instead of falling back.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

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
            "dirt_tpu_torch.utils.convert, dirt_tpu_torch.utils.oracle; "
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
                assert not name.split(".")[0] in ("jax", "dirt_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")


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
    from dirt_tpu_torch.ops import (_cuda, forward_blocks, grad_blocks,
                                    prepass_fused)
    del forward_blocks, grad_blocks, prepass_fused  # register the kernels
    assert sorted(_cuda.KERNELS) == ["grad_prepass", "grad_reduce",
                                     "hit_plane", "raster_sweep"]
    for name, kernel in _cuda.KERNELS.items():
        path, line = kernel.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def _"), (name, text)
        header = (PKG / "csrc" / f"{name}.cu").read_text()[:400]
        assert text[4:text.index("(")] in header, name
        assert f"{name}.cu" in _cuda.SOURCES


def test_cpu_runs_plain_and_other_devices_raise():
    from dirt_tpu_torch.ops import _cuda, forward_blocks
    t = torch.zeros(2, 3)
    assert _cuda.on_cuda(t) is False
    with pytest.raises(ValueError):
        _cuda.on_cuda(torch.zeros(2, 3, device="meta"))
    table = torch.zeros(1, 4, 36, device="meta")
    with pytest.raises(ValueError):
        forward_blocks.hit_plane(table, (20, 21, 22, 23), 1, 1, 16, 16, 0,
                                 16, 16, 0)


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
