"""BENCHMARK.json against the contract's rules: keys, names, units, files
and the relations between cells and metrics."""

import json
import re

import pytest

from bench_h100.harness import check, spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(word) for word in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
    names = [entry["name"] for key in ("configs", "workloads", "end_to_end",
                                       "per_layer") for entry in bench[key]]
    assert all(NAME.match(name) for name in names)
    assert len({e["name"] for e in bench["end_to_end"] + bench["per_layer"]})\
        == len(bench["end_to_end"]) + len(bench["per_layer"])
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for config in bench["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert _line(config["source"]) and _line(config["why"])
        assert config["file"].startswith(tuple(p + "/"
                                               for p in bench["paths"]))
        held = json.loads((spec.ROOT / config["file"]).read_text())
        assert held["name"] == config["name"]
        assert held["reduced"] == config["reduced"]
        # Only the batch may move from the source: never a width or a
        # size of the mesh or the image.
        assert set(config["reduced"]) <= {"batch"}
        mesh = spec.load_module(spec.BENCH_DIR / "meshes" /
                                f"{held['mesh']['kind']}.py", "bench_mesh_")
        assert held["faces"] == len(mesh.make(held["mesh"])["faces"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_mesh_kind_and_entry_has_its_module():
    """Each configuration and traffic mix of the folder, listed in
    BENCHMARK.json or kept for later."""
    read = lambda path: json.loads(path.read_text())
    configs = sorted((spec.BENCH_DIR / "configs").glob("*.json"))
    mixes = sorted((spec.BENCH_DIR / "traffic").glob("*.json"))
    assert configs and mixes
    for path in configs:
        kind = read(path)["mesh"]["kind"]
        assert (spec.BENCH_DIR / "meshes" / f"{kind}.py").is_file(), path
    for path in mixes:
        entry = read(path)["entry"]
        assert (spec.BENCH_DIR / "entries" / f"{entry}.py").is_file(), path


def test_workloads_have_their_files(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        cell = spec.load_cell(w["name"])
        assert set(cell.limits) == set(check.NUMBERS)
        assert all(limit > 0 for limit in cell.limits.values())


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in bench["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in bench["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert _line(metric["layer"]) and metric["moves"] in e2e
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_every_metric_has_its_reader(bench):
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(metric["name"]))


def test_run_seconds_fits_the_check_with_24_cells(bench):
    seconds = bench["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (seconds + 60) + cells * 2 * 90 + 1200 <= 43200
