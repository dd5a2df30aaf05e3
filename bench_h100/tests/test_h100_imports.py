"""Nothing the benchmark runs imports jax or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

from bench_h100 import run
from bench_h100.harness import spec


def _imported(path):
    """Top-level names of the modules a source file imports (absolute
    imports; relative ones stay inside the benchmark)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(
        ["dirt_tpu_torch", "dirt_tpu_torch.ops._cuda", "jaxtyping",
         "flaxen", "torch"]) == []
    assert run.forbidden_modules(["dirt_tpu", "dirt_tpu.ops"]) == ["dirt_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_source_of_the_benchmark_imports_jax_or_chip_smoke():
    for path in spec.BENCH_DIR.rglob("*.py"):
        found = _imported(path) & (set(run.FORBIDDEN) | {"chip_smoke"})
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        assert _imported(path) <= {"torch", "typing"}, path


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import bench_h100.harness.runner, bench_h100.run, "
            "dirt_tpu_torch, dirt_tpu_torch.ops.forward_blocks; "
            "from bench_h100.run import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
