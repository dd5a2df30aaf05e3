"""A later change adds a cell, a configuration, a traffic mix and a
metric as new files plus new BENCHMARK.json entries, and the harness
picks them up with no file of the benchmark edited."""

import hashlib
import json
import shutil

from bench_h100.harness import runner, spec

from .conftest import tiny

METRIC = '''"""dummy.frames_per_step: frames a step of the window (a test's)."""


def read(readings):
    return readings.batch * 1.0
'''


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_make_a_new_cell(tmp_path, blocks_on_cpu):
    bench_dir = tmp_path / "bench_h100"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)

    config = json.loads((bench_dir / "configs" /
                         "cyl512_b16_256.json").read_text())
    config.update(name="cyl2048_b16_256", faces=2048)
    config["mesh"]["segments"] = 256
    (bench_dir / "configs" / "cyl2048_b16_256.json").write_text(
        json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "orbit.json").read_text())
    traffic.update(why="a dolly shot", half_width=0.15)
    (bench_dir / "traffic" / "dolly.json").write_text(json.dumps(traffic))
    (bench_dir / "checks" / "cyl2048_b16_256.dolly.json").write_text(
        json.dumps({"limits": {"pixels": 1e-3, "grads": 1e-3,
                               "loss": 1e-6}}))
    (bench_dir / "metrics" / "dummy.frames_per_step.py").write_text(METRIC)

    bench = spec.load_benchmark()
    bench["configs"].append({"name": "cyl2048_b16_256", "source": "a test",
                             "file": "bench_h100/configs/cyl2048_b16_256.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "cyl2048_b16_256.dolly",
                               "config": "cyl2048_b16_256",
                               "traffic": "dolly", "chips": 1,
                               "why": "a test"})
    frames = next(m for m in bench["end_to_end"]
                  if m["name"] == "frames_per_s")
    frames.setdefault("workloads", []).append("cyl2048_b16_256.dolly")
    bench["per_layer"].append({"name": "dummy.frames_per_step",
                               "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "frames_per_s",
                               "workloads": ["cyl2048_b16_256.dolly"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(bench_dir)
    assert all(after[path] == digest for path, digest in before.items())

    cell = spec.load_cell("cyl2048_b16_256.dolly", root=tmp_path,
                          bench_dir=bench_dir)
    assert cell.config["faces"] == 2048 and cell.traffic["half_width"] == 0.15
    assert "dummy.frames_per_step" in {m["name"] for m in cell.per_layer}
    result = runner.measure(tiny(cell), 5, 0.2, 0, "cpu", 0.0)
    assert result.correct, result.numbers
    dummy = [m for m in cell.per_layer if m["name"].startswith("dummy.")]
    got = runner.metrics(result.readings, dummy, bench_dir)
    assert got == {"dummy.frames_per_step": {"value": 2.0,
                                             "unit": "frames"}}
    e2e = runner.metrics(result.readings, cell.end_to_end, bench_dir)
    assert set(e2e) == {m["name"] for m in cell.end_to_end}
    # The other cells' metrics do not list the new cell's dummy metric.
    other = spec.load_cell("cyl65536_b32_512.distant", root=tmp_path,
                           bench_dir=bench_dir)
    assert "dummy.frames_per_step" not in {m["name"]
                                           for m in other.per_layer}
