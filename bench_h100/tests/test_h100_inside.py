"""The inside cell's files on the CPU: the clipped reference
(reference/clipped.py) equals the whole-image brute force bit for bit,
pixels, residuals and gradients; the cell, its entry point and its mix
load through spec.load_cell and run, cut to a CPU test's size, correct
against that reference; and the cell's three readers read the port's
clip and budget counters, and nothing where the port counts none."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100.harness import runner, spec
from bench_h100.meshes.cylinder import make_cylinder
from bench_h100.reference import autograd, clipped, forward, scene
from dirt_tpu_torch.utils import profiling

from .conftest import tiny

CELL = "cyl65536_b32_512_inside.inside"
METRICS = ("ops.clip.clipped_per_frame", "ops.clip.culled_per_frame",
           "ops.schedule.budget_share")


def soup(seed, batch=2, size=40, num_faces=80):
    """Random triangles, some corners at w <= 0."""
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, 60, 4).astype(np.float32)
    v[..., 3] = rng.uniform(-0.5, 1.5, size=(batch, 60))
    f = rng.randint(0, 60, size=(batch, num_faces, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, 60, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    return tuple(map(torch.as_tensor, (bg, v, c, f)))


def inside(batch=2, size=48, segments=64, seed=0):
    """The benchmark's cylinder with its camera inside (distance 0.3)."""
    vertices, faces = make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    homogeneous = torch.cat([torch.as_tensor(vertices),
                             torch.ones(len(vertices), 1)], 1)
    generator = torch.Generator().manual_seed(seed)
    rotations = torch.rand(batch, 3, generator=generator) * 2 - 1
    view, projection = scene.camera(0.25, 0.3, "cpu")
    clip = scene.clip_vertices(homogeneous, rotations, view, projection)
    colors = torch.rand(batch, len(vertices), 3, generator=generator)
    bg = torch.rand(batch, size, size, 3, generator=generator)
    return bg, clip, colors, torch.as_tensor(faces).expand(
        batch, -1, -1).contiguous()


CASES = {"soup2": lambda: soup(2), "soup5": lambda: soup(5),
         "inside": inside}


def whole_image(monkeypatch):
    """reference.forward with every chunk's window the whole image: the
    face-by-face scan."""
    def windows(vertices, faces, height, width, chunk=forward.CHUNK):
        batch, num_faces = faces.shape[:2]
        row = torch.tensor([0, height - 1, 0, width - 1, 0])
        return row.expand(batch, -(-num_faces // chunk), 5)
    monkeypatch.setattr(forward, "chunk_windows", windows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_clipped_windows_give_the_whole_image_scan(case, monkeypatch):
    bg, v, c, f = CASES[case]()
    weights = torch.rand(bg.shape, generator=torch.Generator().manual_seed(7))
    windows = clipped.chunk_windows(v, f, *bg.shape[1:3])
    got_px, got_aux = clipped.rasterise_batch_plain(bg, v, c, f)
    leaves = [t.clone().requires_grad_(True) for t in (bg, v, c)]
    (clipped.rasterise_batch(*leaves, f) * weights).sum().backward()
    whole_image(monkeypatch)
    want_px, want_aux = forward.rasterise_batch(bg, v, c, f)
    want_leaves = [t.clone().requires_grad_(True) for t in (bg, v, c)]
    (autograd.rasterise_batch(*want_leaves, f) * weights).sum().backward()
    assert (want_aux.face_index >= 0).any()
    assert torch.equal(got_px, want_px)
    for name, a, b in zip(forward.RasterAux._fields, got_aux, want_aux):
        assert torch.equal(a, b), name
    for a, b in zip(leaves, want_leaves):
        assert torch.equal(a.grad, b.grad)
    if case == "inside":
        # Fewer window pixels than reference.forward's, which gives a
        # chunk with a corner at w <= 0 the whole image.
        monkeypatch.undo()
        area = lambda w: int(((w[..., 1] - w[..., 0] + 1)
                              * (w[..., 3] - w[..., 2] + 1))[w[..., 4] == 0]
                             .sum())
        assert area(windows) < area(forward.chunk_windows(v, f,
                                                          *bg.shape[1:3]))


def test_the_cell_loads_and_runs_correct(blocks_on_cpu):
    cell = spec.load_cell(CELL)
    assert cell.traffic["entry"] == "inside"
    assert cell.traffic["distance"] == 0.3 and cell.config["faces"] == 65536
    entry = cell.entry_module()
    assert entry.reference.__module__ == "bench_entry_inside"
    assert entry.rasterise.__module__ == "bench_h100.entries.direct"
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_gib",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    result = runner.measure(tiny(cell, size=32, segments=16), 2 ** 31 + 5,
                            0.2, 0, "cpu", 0.0)
    assert result.correct, result.numbers


def readings(spans, steps=1):
    profile = SimpleNamespace(steps=steps)
    return SimpleNamespace(trace=profile, span_trace=profile, batch=4,
                           _spans=spans)


def step_spans(k, clipped_faces, culled, budget):
    """One step's records: the forward entry, both table spans (the
    forward's with the clip counters) and both runs spans with their
    budget counters."""
    t = 10 ** 9 * k
    span = lambda name, counters, dt: SimpleNamespace(
        name=name, start_ns=t + dt, end_ns=t + dt + 1, stream_ms=1.0,
        counters=counters)
    return [span("dirt.forward", {}, 0),
            span("dirt.forward.table", {"forward.clipped": clipped_faces,
                                        "forward.culled": culled}, 1),
            span("dirt.forward.runs", {"forward.budget": budget[0]}, 2),
            span("dirt.backward.table", {}, 3),
            span("dirt.backward.runs", {"backward.budget": budget[1]}, 4)]


def test_the_readers_read_the_counters(monkeypatch):
    # Two profiled steps, one read (the device-only profile's).
    spans = (step_spans(0, 40000, 60000, (650000, 871234))
             + step_spans(1, 1, 1, (999999, 999999)))
    monkeypatch.setattr(profiling, "records", lambda: spans)
    got = {name: spec.metric_reader(name)(readings(spans))
           for name in METRICS}
    assert got == pytest.approx({"ops.clip.clipped_per_frame": 10000.0,
                                 "ops.clip.culled_per_frame": 15000.0,
                                 "ops.schedule.budget_share": 87.1234})
    # A port without the counters: nothing.
    for r in spans:
        r.counters = {}
    assert all(spec.metric_reader(name)(readings(spans)) is None
               for name in METRICS)
