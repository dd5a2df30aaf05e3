"""The port's stage spans and schedule counters (utils/profiling) on the
blocks path, run on CPU tensors through the kernels' plain versions: no
record and no CUDA event without a profiler; under one, the span tree of
the forward and the gradient with its parents and entries, self times
that sum to the entry's duration, counters equal to the schedules' sums
by hand and to K4's window counts, and truncated visits counted in both
schedules.  The export of
the spans by trace() is tests/test_torch_helpers.py's profiling test."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dirt_tpu_torch
from dirt_tpu_torch import matrices
from dirt_tpu_torch.ops import forward_blocks, grad_blocks
from dirt_tpu_torch.utils import meshes, profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores (torch's small CPU ops then slow down many
    times over)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh, empty recorder for the test, and no event: building one
    raises."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())

    for module in (torch, torch.cuda):
        class NoEvent(module.Event):
            def __new__(cls, *args, **kwargs):
                raise AssertionError("an event was built")
        monkeypatch.setattr(module, "Event", NoEvent)
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "blocks")


FORWARD = ["dirt.forward.table", "dirt.forward.hits", "dirt.forward.runs",
           "dirt.forward.sweep", "dirt.forward.finalize"]
BACKWARD = ["dirt.backward.prepass", "dirt.backward.table",
            "dirt.backward.hits", "dirt.backward.runs",
            "dirt.backward.reduce", "dirt.backward.scatter"]
SIZE = 32


def scene(batch=2, segments=8, channels=3):
    """The bench's cylinder seen from 3 units, random rotations, colours
    and background (numpy seed 0): (background, clip, colours, faces)."""
    rng = np.random.RandomState(0)
    vertices, faces = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    homogeneous = torch.cat([t(vertices), torch.ones(len(vertices), 1)], 1)
    view = matrices.compose(matrices.translation(t([0., 0., -3.])),
                            matrices.rodrigues(t([-0.4, 0., 0.])))
    projection = matrices.perspective_projection(
        near=0.1, far=20., right=0.25, aspect=1., device="cpu")
    rotations = matrices.rodrigues(t(rng.uniform(-1, 1, (batch, 3))))
    clip = (torch.einsum("vi,bij->bvj", homogeneous, rotations)
            @ view @ projection).contiguous()
    colors = t(rng.uniform(size=(batch, len(vertices), channels)))
    background = t(rng.uniform(size=(batch, SIZE, SIZE, channels)))
    faces = torch.as_tensor(faces, dtype=torch.int32).expand(
        batch, -1, -1).contiguous()
    return background, clip, colors, faces


def step(deferred=False):
    """One forward and backward through the autograd entry point on the
    blocks backend."""
    background, clip, colors, faces = scene(channels=4 if deferred else 3)
    leaves = [x.requires_grad_(True) for x in (background, clip, colors)]
    if deferred:
        pixels = dirt_tpu_torch.rasterise_batch_deferred(
            *leaves, faces, lambda gbuffer: gbuffer[..., :3] * 2.0,
            backend="blocks")
    else:
        pixels = dirt_tpu_torch.rasterise_batch(*leaves, faces,
                                                backend="blocks")
    pixels.square().sum().backward()


def self_ns(record, spans):
    """The record's duration less the part of it its children cover."""
    children = sorted((r.start_ns, r.end_ns) for r in spans
                      if r.parent == record.id)
    covered, t = 0, record.start_ns
    for start, end in children:
        start, end = max(start, t), min(end, record.end_ns)
        if end > start:
            covered += end - start
            t = end
    return record.end_ns - record.start_ns - covered


def test_without_a_profiler_nothing_is_recorded(recorder):
    step()
    step(deferred=True)
    assert profiling.records() == []
    assert len(profiling._RECORDER.buffer) == 0
    t = torch.zeros(1)
    assert profiling.span("a", t) is profiling.span("b", t)
    profiling.count("a", t)
    assert len(profiling._RECORDER.buffer) == 0


@pytest.mark.parametrize("deferred", [False, True])
def test_the_span_tree_under_a_profiler(recorder, deferred):
    with profile(activities=[ProfilerActivity.CPU]):
        step(deferred)
    spans = profiling.records()
    by_id = {r.id: r for r in spans}
    roots = [r for r in spans if r.parent is None]
    assert [r.name for r in roots] == (
        ["dirt.forward", "dirt.shade", "dirt.backward"] if deferred
        else ["dirt.forward", "dirt.backward"])
    for root, names in ((roots[0], FORWARD), (roots[-1], BACKWARD)):
        tree = [r for r in spans if r.entry == root.id]
        assert [r.name for r in tree] == [root.name] + names
        assert all(by_id[r.parent] is root for r in tree[1:])
        assert len({r.thread for r in tree}) == 1
        assert sum(self_ns(r, tree) for r in tree) == (root.end_ns
                                                       - root.start_ns)
    assert all(r.stream_ms is None and r.end_ns >= r.start_ns
               for r in spans)
    counters = {r.name: set(r.counters) for r in spans if r.counters}
    assert counters == {
        "dirt.forward.table": {"forward.clipped", "forward.culled"},
        "dirt.forward.hits": {"forward.hit_window"},
        "dirt.forward.runs": {"forward.visits", "forward.dropped",
                              "forward.budget"},
        "dirt.forward.sweep": {"forward.chain"},
        "dirt.backward.hits": {"backward.hit_window"},
        "dirt.backward.runs": {"backward.dropped", "backward.budget"}}


def _hand_counts(hit, num_slots):
    """(visits, dropped, budget) of a [B, R, I] hit matrix under
    `num_slots` slots an image, by hand: every hit is a visit, the
    schedule keeps num_slots of them an image; budget is the fullest
    image's visits in parts per million of the slots."""
    per_image = hit.reshape(hit.shape[0], -1).sum(dim=1).tolist()
    kept = [min(n, num_slots) for n in per_image]
    return (sum(kept), sum(n - k for n, k in zip(per_image, kept)),
            max(per_image) * 10 ** 6 // num_slots)


def table_and_hits(module, pass_, *scene_args):
    """A pass's sorted face table [B, NB*chunk, D], from its pack, and its
    [B, T, NB] block hits, from hit_matrix with the pass's columns and
    dilation, as its schedule builds them."""
    table = module.pack(*scene_args, SIZE, SIZE, module.TILE_H,
                        module.TILE_W, module.CHUNK)[0]
    table = table.reshape(scene_args[0].shape[0], -1, table.shape[-1])
    hit = forward_blocks.hit_matrix(
        table, pass_.bbox, table.shape[1] // module.CHUNK, module.CHUNK,
        -(-SIZE // module.TILE_H), -(-SIZE // module.TILE_W), module.TILE_H,
        module.TILE_W, edge_cols=pass_.edge, height=SIZE, width=SIZE,
        dilate=pass_.dilate)
    return table, hit


@pytest.mark.parametrize("slots", [0, 28])
def test_counters_equal_the_schedules_sums(recorder, monkeypatch, slots):
    """At 28 slots an image the gradient's dilated hits (31 and 30 an
    image) overflow where the forward's (27 and 25) do not."""
    monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", str(slots))
    background, clip, colors, faces = scene(segments=32)
    tiles = (SIZE, SIZE, forward_blocks.TILE_H, forward_blocks.TILE_W,
             forward_blocks.CHUNK)
    table, hit = table_and_hits(forward_blocks, forward_blocks.FORWARD,
                                clip, colors, faces)
    grad_table, grad_hit = table_and_hits(grad_blocks, grad_blocks.GRADIENT,
                                          clip, faces)
    grid = (hit.shape[2], forward_blocks.CHUNK, -(-SIZE // tiles[2]),
            -(-SIZE // tiles[3]), *tiles[2:4])
    windows = [int(forward_blocks.hit_windows(t, bbox, *grid).sum())
               for t, bbox in ((table, forward_blocks._BBOX),
                               (grad_table, grad_blocks._BBOX))]
    with profile(activities=[ProfilerActivity.CPU]):
        forward = forward_blocks.pack(clip, colors, faces, *tiles)
        grad_blocks.pack(clip, faces, *tiles)
    counters = {}
    for r in profiling.records():
        for name, value in r.counters.items():
            counters[name] = counters.get(name, 0) + value

    visits, dropped, budget = _hand_counts(
        hit, forward_blocks.slots_per_image(*hit.shape[1:]))
    _, grad_dropped, grad_budget = _hand_counts(
        grad_hit, forward_blocks.slots_per_image(*grad_hit.shape[2:0:-1]))
    # Seen from 3 units, no corner reaches w <= 0: nothing is clipped.
    assert counters == {"forward.visits": visits, "forward.dropped": dropped,
                        "backward.dropped": grad_dropped,
                        "forward.hit_window": windows[0],
                        "backward.hit_window": windows[1],
                        "forward.budget": budget,
                        "backward.budget": grad_budget,
                        "forward.clipped": 0, "forward.culled": 0}
    assert (grad_budget > 10 ** 6) == (grad_dropped > 0)
    assert visits == int(forward[2].sum())
    assert dropped == int(forward[4].sum())
    assert dropped == 0 and (grad_dropped > 0) == (slots > 0)


@pytest.mark.parametrize("piece", [1, 2, forward_blocks.SWEEP_PIECE])
def test_chain_counts_the_longest_block_of_the_sweep(recorder, monkeypatch,
                                                    piece):
    # forward.chain: the most visits one K1 block sweeps, the longest run
    # cut at the piece.
    sweep = forward_blocks.raster_sweep
    monkeypatch.setattr(forward_blocks, "raster_sweep",
                        lambda *args: sweep(*args, piece=piece))
    background, clip, colors, faces = scene(segments=32)
    with profile(activities=[ProfilerActivity.CPU]):
        forward_blocks.rasterise_batch(background, clip, colors, faces)
    counts = forward_blocks.pack(clip, colors, faces, SIZE, SIZE,
                                 forward_blocks.TILE_H, forward_blocks.TILE_W,
                                 forward_blocks.CHUNK)[2]
    chain = [r.counters for r in profiling.records()
             if r.name == "dirt.forward.sweep"]
    assert chain == [{"forward.chain": min(int(counts.max()), piece)}]
    assert int(counts.max()) > 2


def test_a_small_slot_budget_drops_in_both_schedules(recorder, monkeypatch):
    monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", "4")
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    dropped = {name: value for r in profiling.records()
               for name, value in r.counters.items() if "dropped" in name}
    assert dropped["forward.dropped"] > 0
    assert dropped["backward.dropped"] > 0
