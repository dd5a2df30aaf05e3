"""The port's near/far-clipped face bboxes on the CPU (the plain rule of
forward_pallas.pixel_bbox, which K13 writes bit for bit on the card).

A face covers a pixel only where its point on the pixel's ray has w > 0
and -w <= z <= w, so a face with a corner at w <= 0 takes the bbox of
its part inside those planes, or the empty bbox where it has none.  On
camera-crossing soups, tests/test_clipping.py's 12-vertex scene and the
512-face bench cylinder with the camera inside it:

  * every fragment a face covers lies in its forward table's bbox, and
    every pixel within one pixel of one in its gradient table's (widened
    a pixel for the dilation);
  * the faces the clip empties cover nothing;
  * faces with every w > 0 keep dirt_tpu's bbox bit for bit;
  * on the inside cylinder the blocks forward and gradient equal the
    reference backend's and the plain scatter gradient, dropping nothing,
    and the table spans count the clipped and the culled faces;
  * under the full-screen rule (dirt_tpu's) the inside cylinder at 8,192
    faces and 256^2 overflows the schedules' default slot budgets; under
    the clip it drops nothing.
"""

import functools
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dirt_tpu.ops import forward_pallas as jforward_pallas
from dirt_tpu.ops import grad_tables as jgrad_tables
from dirt_tpu_torch.ops import (backward, dispatch, forward_blocks,
                                forward_pallas, geometry, grad_blocks)
from dirt_tpu_torch.utils import profiling

import clip_bbox

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TOL = 3e-6


def soup(seed):
    """A camera-crossing soup (chip_smoke.crossing_scene): 200 faces, 2
    images of 64^2."""
    return chip_smoke.crossing_scene("cpu", size=64, seed=seed)


SCENES = {
    "soup3": lambda: soup(3),
    "soup4": lambda: soup(4),
    "test_clipping": lambda: chip_smoke.clip_test_scene("cpu"),
    "inside512": lambda: chip_smoke.bench_scene(
        2, 64, 64, "cpu", distance=chip_smoke.CROSSING_DISTANCE),
}


def tables(scene):
    """(forward table, gradient table) of the scene in face order, the
    plain path's, and the scene's (vertices, faces, height, width)."""
    background, clip, colors, faces, _ = scene
    height, width = background.shape[1:3]
    rows = faces.shape[1]
    forward = forward_blocks.face_table(clip, faces, colors, height, width,
                                        rows)[0]
    gradient = forward_blocks.face_table(clip, faces, None, height, width,
                                         rows)[0]
    return forward, gradient, (clip, faces, height, width)


def status(clip, faces, height, width):
    """[B, F] numpy clip status of the faces (forward_pallas.CLIPPED ...)."""
    return forward_pallas.clip_status(geometry.gather_corners(clip, faces),
                                      height, width).numpy()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_forward_bbox_holds_every_covered_fragment(scene):
    forward, _, (clip, faces, height, width) = tables(SCENES[scene]())
    covered = clip_bbox.assert_contained(
        clip, faces, [forward[..., c] for c in forward_blocks._BBOX],
        height, width)
    assert covered > 0
    assert (status(clip, faces, height, width)
            == forward_pallas.CLIPPED).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_gradient_bbox_holds_every_pixel_a_pixel_from_one(scene):
    _, gradient, (clip, faces, height, width) = tables(SCENES[scene]())
    clip_bbox.assert_contained(
        clip, faces, [gradient[..., c] for c in grad_blocks._BBOX], height,
        width, dilate=1)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_culled_faces_cover_nothing(scene):
    _, clip, _, faces, _ = SCENES[scene]()
    height, width = SCENES[scene]()[0].shape[1:3]
    culled = status(clip, faces, height, width) == forward_pallas.CULLED
    assert culled.any()
    covered = clip_bbox.coverage(clip, faces, height, width)
    assert not covered[culled].any()
    # Wholly behind the camera is culled.
    assert culled[chip_smoke.behind_faces(clip, faces).numpy()].all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_faces_in_front_keep_dirt_tpu_bbox(scene):
    forward, gradient, (clip, faces, height, width) = tables(
        SCENES[scene]())
    v, f = clip.numpy(), faces.numpy()
    colors = np.zeros(v.shape[:2] + (3,), np.float32)
    want_forward = np.asarray(jax.vmap(functools.partial(
        jforward_pallas._face_table, height=height, width=width,
        pad_rows=0))(v, colors, f))
    want_gradient = np.asarray(jax.vmap(functools.partial(
        jgrad_tables._grad_face_table, height=height, width=width,
        pad_rows=0))(v, f))
    front = ~clip_bbox.unbounded(clip, faces)
    assert front.any()
    for got, want, bbox in ((forward, want_forward, forward_blocks._BBOX),
                            (gradient, want_gradient, grad_blocks._BBOX)):
        np.testing.assert_array_equal(got.numpy()[front][:, list(bbox)],
                                      want[front][:, list(bbox)])


def test_blocks_equal_the_reference_inside_the_cylinder():
    background, clip, colors, faces, weights = SCENES["inside512"]()
    want_px, want_aux = dispatch.forward_batch(background, clip, colors,
                                               faces, "reference")
    got_px, got_aux = dispatch.forward_batch(background, clip, colors,
                                             faces, "blocks")
    assert bool((want_aux.face_index >= 0).all())   # every pixel covered
    torch.testing.assert_close(got_aux.face_index, want_aux.face_index,
                               rtol=0, atol=0)
    torch.testing.assert_close(got_px, want_px, atol=1e-4, rtol=1e-5)
    assert int(got_aux.dropped.max()) == 0
    grad_pixels = weights
    want = backward.rasterise_grad_batch(clip, faces, want_px, grad_pixels,
                                         want_aux, implementation="xla")
    got = backward.rasterise_grad_batch(clip, faces, got_px, grad_pixels,
                                        got_aux, implementation="blocks")
    for name in ("grad_background", "grad_vertices", "grad_vertex_colors"):
        a, b = getattr(want, name).numpy(), getattr(got, name).numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b / scale, a / scale, atol=TOL,
                                   err_msg=name)
    height, width = background.shape[1:3]
    for pass_, attrs in ((forward_blocks.FORWARD, colors),
                         (grad_blocks.GRADIENT, None)):
        _, _, dropped, _ = forward_blocks.schedule(
            pass_, clip, faces, attrs, height, width, forward_blocks.TILE_H,
            forward_blocks.TILE_W, forward_blocks.CHUNK, False)
        assert int(dropped.max()) == 0, pass_.name


def test_the_table_spans_count_clipped_and_culled_faces(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())
    background, clip, colors, faces, _ = SCENES["inside512"]()
    height, width = background.shape[1:3]
    tiles = (forward_blocks.TILE_H, forward_blocks.TILE_W,
             forward_blocks.CHUNK)
    with profile(activities=[ProfilerActivity.CPU]):
        forward_blocks.pack(clip, colors, faces, height, width, *tiles)
        grad_blocks.pack(clip, faces, height, width, *tiles)
    counters = {}
    for r in profiling.records():
        for name, value in r.counters.items():
            counters.setdefault(r.name, {})[name] = value
    clip_status = status(clip, faces, height, width)
    valid = geometry.face_setup(clip, faces).valid.numpy()
    clipped = int((valid & (clip_status == forward_pallas.CLIPPED)).sum())
    culled = int((valid & (clip_status == forward_pallas.CULLED)).sum())
    assert clipped > 0 and culled > 0
    # Both passes' tables clip the same faces: the forward's span counts.
    assert counters["dirt.forward.table"] == {"forward.clipped": clipped,
                                              "forward.culled": culled}
    assert "dirt.backward.table" not in counters
    for name in ("forward", "backward"):
        assert 0 < counters[f"dirt.{name}.runs"][f"{name}.budget"] < 10 ** 6


def test_the_full_screen_rule_overflows_the_budgets(monkeypatch):
    """dirt_tpu's rule gives every face with a corner at w <= 0 the
    screen: the forward's and the gradient's default budgets overflow at
    8,192 faces inside the cylinder at 256^2, where the clip's bboxes
    fit."""
    background, clip, colors, faces, _ = chip_smoke.bench_scene(
        1, 256, 1024, "cpu", distance=chip_smoke.CROSSING_DISTANCE)
    height, width = background.shape[1:3]

    def dropped():
        out = {}
        for pass_, attrs in ((forward_blocks.FORWARD, colors),
                             (grad_blocks.GRADIENT, None)):
            out[pass_.name] = int(forward_blocks.schedule(
                pass_, clip, faces, attrs, height, width,
                forward_blocks.TILE_H, forward_blocks.TILE_W,
                forward_blocks.CHUNK, False)[2].sum())
        return out

    assert dropped() == {"forward": 0, "backward": 0}
    clipped = forward_pallas._clipped_bounds
    full_screen = lambda corners, height, width: (
        *clipped(corners, height, width)[:4],
        torch.full(corners.shape[:-2], forward_pallas.WHOLE))
    monkeypatch.setattr(forward_pallas, "_clipped_bounds", full_screen)
    assert min(dropped().values()) > 0
