"""One short run of each cell on the card (marked `cuda`: skips without
one).  On the card:

    python -m pytest bench_h100/tests/test_h100_chip.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from bench_h100.harness import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in spec.load_benchmark()["workloads"]:
        out = subprocess.run(
            [sys.executable, "bench_h100/run.py", "--workload",
             workload["name"], "--seed", str(2 ** 31 + 3), "--seconds", "2",
             "--trace", str(trace)], cwd=spec.ROOT, capture_output=True,
            text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert list(line)[-1] == "checks"
