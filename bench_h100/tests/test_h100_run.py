"""The command's exits: no result without CUDA, and none in a checkout
that holds only BENCHMARK.json and the benchmark's folder."""

import shutil
import subprocess
import sys

import pytest
import torch

from bench_h100.harness import spec

ARGS = ["--workload", "cyl65536_b32_512.distant", "--seed", str(2 ** 31 + 7),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "bench_h100/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "dirt_tpu_torch" in out.stderr
