"""Shared fixtures of the benchmark's CPU tests.

Run them from the checkout's root:

    python -m pytest bench_h100/tests -q

Tests marked `cuda` need the card and skip without one (decided inside
each test)."""

import copy
import json

import pytest
import torch

from bench_h100.harness import spec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: test files run in parallel processes,
    and a thread pool per core in each oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cell_from_files(config, traffic, checks):
    """A cell built from a configuration, a traffic mix and a checks file
    of this benchmark's folder, listed in BENCHMARK.json or not."""
    read = lambda *parts: json.loads(spec.BENCH_DIR.joinpath(*parts)
                                     .read_text())
    return spec.Cell(name=checks, chips=1,
                     config=read("configs", f"{config}.json"),
                     traffic=read("traffic", f"{traffic}.json"),
                     limits=read("checks", f"{checks}.json")["limits"],
                     end_to_end=[], per_layer=[])


def tiny(cell, batch=2, size=24, segments=8, pool=4):
    """`cell` (a name in BENCHMARK.json, or a Cell) cut to a CPU test's
    size: the same files and limits, a small batch, image, mesh and pose
    pool."""
    if isinstance(cell, str):
        cell = spec.load_cell(cell)
    cell = copy.deepcopy(cell)
    cell.config.update(batch=batch, height=size, width=size)
    cell.config["mesh"]["segments"] = segments
    cell.traffic.update(pool=pool, kept_entries=min(2, pool), trace_steps=2)
    return cell


@pytest.fixture
def blocks_on_cpu(monkeypatch):
    """The port's blocks backend and gradient on CPU tensors (its plain
    versions of the kernels), as the default dispatch picks them on the
    card."""
    monkeypatch.setenv("DIRT_TPU_TORCH_BACKEND", "blocks")
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "blocks")
