"""Cells, configurations, traffic mixes, limits, meshes, entry points and
per-layer metric readers, found by name.

BENCHMARK.json at the checkout's root lists the cells as (configuration,
traffic) pairs.  A configuration is the JSON file its entry names; a
traffic mix is traffic/<name>.json, a cell's limits checks/<cell>.json,
the mesh of a configuration meshes/<its mesh.kind>.py, the entry point
of a mix entries/<its entry>.py and a per-layer metric's reader
metrics/<metric name>.py, all under this benchmark's folder.  A new
cell, configuration, mix, mesh, entry point or metric is new files and
new BENCHMARK.json entries: no file here names one.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict         # the configuration file's contents
    traffic: dict        # traffic/<name>.json
    limits: dict         # checks/<cell>.json: {number: limit}
    end_to_end: list     # BENCHMARK.json's end_to_end entries of this cell
    per_layer: list      # its per_layer entries that read this cell
    bench_dir: Path = BENCH_DIR  # the folder of its mesh and entry modules

    def __post_init__(self):
        # A missing mesh or entry module fails here, before any set-up.
        self._path("meshes")
        self._path("entries")

    def _path(self, folder):
        key, name = (("mesh.kind", self.config["mesh"]["kind"])
                     if folder == "meshes"
                     else ("entry", self.traffic["entry"]))
        path = Path(self.bench_dir) / folder / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"cell {self.name!r}: its {key} {name!r} "
                                    f"needs {path}, which does not exist")
        return path

    def mesh_module(self):
        """meshes/<the configuration's mesh.kind>.py: its `make`."""
        return load_module(self._path("meshes"), "bench_mesh_")

    def entry_module(self):
        """entries/<the traffic mix's entry>.py: the step's hooks
        (entries/__init__.py)."""
        return load_module(self._path("entries"), "bench_entry_")


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reads(metric, cell_name, reported=None):
    """Whether the cell reads `metric`: the cells its `workloads` lists;
    without that key every cell, or for a per-layer metric every cell
    that reports the end-to-end metric it moves (`reported`)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name, root=ROOT, bench_dir=BENCH_DIR):
    """The cell `name` of BENCHMARK.json with its files; KeyError where
    BENCHMARK.json has no such cell."""
    benchmark = load_benchmark(root)
    workloads = {w["name"]: w for w in benchmark["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(workloads)}")
    workload = workloads[name]
    config = next(c for c in benchmark["configs"]
                  if c["name"] == workload["config"])
    read = lambda path: json.loads(Path(path).read_text())
    end_to_end = [m for m in benchmark["end_to_end"] if _reads(m, name)]
    reported = {m["name"] for m in end_to_end}
    return Cell(
        name=name, chips=workload["chips"],
        config=read(Path(root) / config["file"]),
        traffic=read(Path(bench_dir) / "traffic" / f"{workload['traffic']}.json"),
        limits=read(Path(bench_dir) / "checks" / f"{name}.json")["limits"],
        end_to_end=end_to_end,
        per_layer=[m for m in benchmark["per_layer"]
                   if _reads(m, name, reported)],
        bench_dir=Path(bench_dir))


def load_module(path, prefix):
    """The module of the file `path`, named `prefix` + its stem."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name, bench_dir=BENCH_DIR):
    """The `read(trace)` function of metrics/<name>.py."""
    return load_module(Path(bench_dir) / "metrics" / f"{name}.py",
                       "bench_metric_").read
