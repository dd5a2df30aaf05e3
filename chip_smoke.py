#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dirt_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --sweeps-of OTHER_CHECKOUT   # phase 5: sweeps, K1, K11

It drives the port's paths on the bench scene (16 x 256^2, the 512-face
Gouraud cylinder, loss sum(pixels * weights)) and checks them phase by
phase, printing one line per phase and exiting non-zero at the first
failure:

  1. device: torch and CUDA versions, the card's name and power limit;
     no CUDA device is a failure (nothing runs on the CPU);
  2. build: the fourteen CUDA kernels, compiled from dirt_tpu_torch/csrc/;
  3. kernels vs their plain PyTorch versions on the card, at the paths'
     shapes and on a 100x100 image, a camera-crossing scene and a
     1 x 256^2 x 8192-face cylinder: the forward pack's Morton-sorted
     face table and its order (K13, as bits), block hits (K4), the CSR runs of
     the forward's hits (K12: starts, counts, ids and dropped), the
     sweeps' states
     (K1, K7, the slot sweep K5b and, where the image's table fits a
     block's shared memory, the resident sweep K5; K5b and K5 also ==
     K1's state), the plane stack (K2, also with the opt-in diagonal
     dilation) and the fused sweep-and-shade outputs (K8) bitwise, the
     pixels after finalize bitwise, the four reductions' rows (K3, K6,
     K9, K10) within max |d| / max(max |a|, 1) <= 1e-5 (the summation
     order differs) and K6's rows == K3's; on the camera-crossing scene a
     truncating slot budget (DIRT_TPU_TORCH_SLOTS_PER_IMAGE), whose
     dropped count must be the one the fused runs imply and whose cut
     tiles must be background (cut face blocks: zero rows); on the bench
     inputs K3 and K6 each give equal rows in two calls, and on runs of
     0, 1, 37 and more visits than a block's shared visit list K6 == K3
     bit for bit, both within 1e-5 of their plain versions, the empty
     run's rows zero; K1 and K5b each give equal states in two calls on
     every scene, and on runs of 0, 1, 121 and more visits than their
     visit list (the staging's two halves, several pieces) K1 and K5b ==
     their plain versions bit for bit and K5b == K1, K1 also with every
     run cut into pieces of 1 and 2 visits; K8 and K5 each give
     equal results in two calls; on the 8192-face image K8 and K7 on
     lists of 0, 1, 301 and 3,728 faces (more than their visit list and
     their staging area hold) == their plain versions bit for bit and in
     two calls, K7's pixels after finalize == K8's, the unlisted tiles
     background; K5 == its plain version == K1 bit for bit with every
     count zeroed (every group empty), on the zoom scene and on a
     1,536-face scene (16 x 256^2, whose table nears a block's shared
     memory); K4 on the forward and the gradient pack's tables of the
     bench, zoom, 8192-face, 1,536-face and camera-crossing scenes, the
     bench's with degenerate rows (empty, reversed and non-finite bboxes,
     NaN edges), a ragged cut of the 100x100 one and 70,000 images of 5
     faces, each padded to blocks of 8, 32, 64 and 128 faces, at dilate 0
     and 1, with and without the edge cull: block hits and window counts
     == its plain version's bit for bit;
  4. paths, each with every launch counter reset just before and read just
     after, failing if a kernel of the path was not launched:
     a. blocks (the default): rasterise_batch forward + backward; image 0
        against the native C++ oracle; the winner map against the
        reference backend; gradients against the plain scatter gradient
        from the same forward output; no dropped visits;
     b. dense (backend="dense"): the same step; winner map == the blocks
        backend's and the oracle's, pixels within 1e-4; gradients against
        the plain scatter gradient; no dropped hits;
     c. deferred, on the blocks and the dense backend: a 10-channel
        G-buffer (mask, clip positions, albedo, normals) shaded by an
        ambient + Lambert shader that closes over a light-direction leaf;
        the fused deferred backward against the two-call form, a finite,
        non-zero light gradient, finite vertex and attribute gradients;
     d. pallas (backend="pallas"): the direct step; pixels and every aux
        field == the blocks backend's, image 0 against the oracle,
        gradients against the plain scatter gradient, no dropped hits;
     e. mxu (the blocks forward with DIRT_TPU_TORCH_GRAD_BACKEND=mxu, set
        and restored around each use): gradients against the plain
        scatter gradient, rasterise_grad_debug's debug image == the plain
        gradient's, and the deferred step (mxu's two-call fallback) against
        the fused blocks deferred step, all within 3e-6;
     f. slots (forward_blocks.FUSED and grad_blocks.FUSED off, set and
        restored around each use): the direct step, pixels and every aux
        field == the blocks path's, gradients against the plain scatter
        gradient; the deferred step against the fused blocks deferred
        step within 3e-6;
     g. resident (forward_blocks.RESIDENT_MB = 0, auto): the direct step,
        pixels and every aux field == the blocks path's, gradients against
        the plain one; on the 8192-face cylinder, whose table exceeds a
        block's shared memory, the forward launches K1 and not K5;
     h. repro: K11 scalar_accum at the repro's own sizes and on 256 tiles
        x 8 chunks with random counts, within 1e-5 of its plain version
        and within the repro's 1e-3 of its numpy reference;
     i. models: the renderer models (dirt_tpu_torch.models) at the
        samples' 640x480, forward and backward on the card: Gouraud on the
        split cube and on the bench's 512-face cylinder split by face
        (gradient to the object rotation), deferred Phong on the cube (to
        the light direction) and textured on samples/textured.py's prism
        (to the texture and the light; both deferred renderers also
        differentiate the rotation, so their G-buffer's backward runs);
        K4, K1, K2 and K3 launched; pixels within 1e-4 of the same model
        on the CPU, those gradients within 1e-4 of the CPU's max |grad|
        (Gouraud's where the CPU's rasteriser sees the card's clip and lit
        values: the occluder dilation's exact compares make the rotation
        gradient jump with an ulp of the scene math);
     j. samples: the three samples' fits (dirt_tpu_torch.samples) on the
        card at 160x120, simple 40 steps, deferred 20, textured 15 (the
        stripes texture where PIL is missing); each loss must fall;
     k. sharded (dirt_tpu_torch.parallel, every rank a process started by
        launch.run_ranks, after the kernels were built once here): the
        batch-sharded step (the bench over 2 ranks x 8 images) and the
        face-sharded step (the bench, 256 faces a rank, and the
        8,192-face cylinder, 4,096 a rank) over gloo at world size 2; the
        2 x 2 layout (batch x faces) of the bench over gloo at 4; the
        batch- and face-sharded bench step over NCCL at 1 (and at one rank
        a card where there are several cards); then dryrun_multichip(2)
        over gloo.  Every gloo rank shares the one card.  Each rank's
        pixels == the unsharded blocks render of its images (face-sharded:
        pixels and every aux field, up to the sign of zero), gradients
        within 3e-6 (batch) or 3e-5 (faces, normalised) of the unsharded
        step's, the background gradient of a face-sharded step equal, the
        winners on both ranks, and K4, K1, K2 and K3 launched on every
        rank in its step (counters reset just before it, read just after);
        a rank that raises fails the run; each step's median ms and
        profiler device ms per rank, with the transport;
     l. scale (check_scale): a. sweeps/_sweep_r2.py's six configurations
        (16 x 128^2, 16 x 256^2 and 4 x 512^2 at 512 faces, 16 x 256^2 at
        2,048 and 8,192, 4 x 512^2 at 65,536) and the 65,536-face mesh
        zoomed in (ZOOM_RIGHT): the blocks step and the dense step, each
        counted and recorded, blocks dropping nothing, dense's winner map
        == blocks', gradients within 3e-6 of the plain gradient; where
        dense's default per-tile cap drops hits (65,536 faces), its checks
        run with DIRT_TPU_TORCH_TILE_FACE_CAP=0 (no cap), set and restored
        around them, and the default's drops and changed image-0 pixels
        are printed; image 0's winner maps == the f32 native oracle's,
        pixels within 1e-4, and at 65,536 faces the f64 oracle's
        adjudication counts (kernel != f64, f32 oracle != f64); each
        step's ms, device ms, busy share, largest items and peak memory,
        and from 8,192 faces each path kernel alone beside its bound;
        b. camera crossing: tests/test_clipping.py's 12-vertex scene and
        the bench cylinder with the camera inside it (view translation
        -0.3): the blocks, dense, pallas and mxu steps counted and
        recorded, gradients finite and within 3e-6 of plain, no face
        wholly behind the camera drawn, every image's blocks, dense and
        pallas winner maps == the native oracle's, and against the GL
        clipping oracle (rasterise_clipped) only within one pixel of its
        boundaries on under 2% of the pixels; and the benchmark cell
        cyl65536_b32_512_inside's scene (INSIDE_CELL: 32 x 512^2, 65,536
        faces, the camera inside) on the blocks path alone: K13 == plain
        on both packs' tables, dropped 0 in both schedules (the fullest
        image's share of its slot budget printed), no face wholly behind
        the camera drawn, gradients finite, image 0's winner map == the
        native oracles' as above; c. the cylinder Jacobian of
        tests/test_cylinder_jacobian.py at 48 x 36: background rows within
        1e-4 of central differences, translation x/y within rtol 0.35, z
        by sign, 30 steps of rotation descent under 0.4 x the initial
        error.  The oracle's calls (one f32 and one f64 at each 65,536-face
        row, minutes each) run in threads from just after the build and
        are held last; the phase prints its seconds;
     Every kernel call a path makes (the deferred path's two-call form
     included) is also recorded and held against its plain version on the
     same inputs, bitwise or within 1e-5 as above; then lines give K1's
     busy runs and visits per busy run at the bench and K1's and K5b's
     launch shape, the bench's visits per run and the launch shape (pixel
     lanes, ring depth, colour group) of each K3 and K6 call the paths
     made, K9's
     window pixels per live slot and the launch shape of each K9 call
     (warps, slots a warp, colour group), and K10's live chunks and bands
     and the launch shape of each K10 call (chunks a block, shared
     bytes);
  5. timing (CUDA events, median of 25): each path's step, with its device
     time per step, busy share, largest device items and the reductions'
     (K3/K6, K9, K10) device time from torch.profiler; the forward sweeps
     on the bench scene, a timing-only "zoom" scene (the bench with the
     projection's half-width 0.05 for 0.25: many busy tiles) and the
     large one (K1, K5b, K7, K8; K5 on the bench, zoom and 1,536-face
     scenes; K4 at dilate 0 and 1 on all four), profiler device ms and
     CUDA-event ms; K1 alone on the 65,536-face cylinder at 4 and 32 x
     512^2 and from inside it at 32 x 512^2 (time_k1_cells: the runs'
     lengths and the longest block, == its plain version bit for bit,
     device ms beside its bound; with --sweeps-of, on the other tree); K4
     alone on both packs' tables of the 65,536-face
     cylinder at 4 and 32 x 512^2 beside its bound; K12 on both packs'
     hits of that cylinder at 32 x 512^2 (check_build_runs: == its plain
     version at the pack's budget and a truncating one, both
     orientations, then its device ms beside its bound and the plain
     version's ms); K13 on both packs' tables of that cylinder at 32 x
     512^2 and on edge rows (degenerate, w <= 0 and just above it, NaN,
     off-screen; 3, 6 and 10 channels and the gradient's layout), sorted
     and in face order (check_face_table: keys, order, rows and table ==
     the plain path's as bits, 2 launches a sorted table; the blocks step
     at 4 x 512^2 with K13's tables and the plain path's: pixels ==,
     gradients within 3e-6), then its device ms beside its bound and the
     plain path's ms; each kernel, by
     CUDA-event ms and by the profiler's device ms of its CUDA kernel (a
     kernel the profiler does not see fails the run), against its plain
     version, its bound (for
     K3 and K6 the planes of the tiles their runs visit, for K9 of the
     pixels in its windows, each once, with the bound from the whole
     image's planes beside it; for K10 the products of the mask's
     non-zero entries) and, for the reductions, their library form (K3,
     K6, K9: the segment sum, per-pixel rows plus torch.index_add; K10:
     the masks built from the same ids and one float32 batched matmul,
     TF32 off; K11: its masks times its values, one float32 bmm); each
     renderer model's forward + backward step at 640x480 (phase 4i's
     scenes), timed and profiled as the paths are; K11 alone at both of
     its sizes (profiler device ms, CUDA-event ms, bound);
  6. the kernels' JSON line, the card's name and power limit, and last the
     result line {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

GRAD_TOL = 3e-6      # normalised, as dirt_tpu's tests/test_grad_kernels.py
# K3/K9/K10 rows: max |kernel - plain| / max(max |plain|, 1)
ROW_TOL = 1e-5
STEPS = 25
PROFILE_STEPS = 10
PROFILE_TRIES = 3     # profiles of one measurement at most (profiled)
# The H100 SXM's published peaks: device memory 3.35 TB/s, float32
# outside the tensor cores 67 TFLOP/s, bf16 dense tensor cores 989 TFLOP/s.
PEAK_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = 67e9
PEAK_BF16_OPS_PER_MS = 989e9
# Operations counted per unit of work, every arithmetic, compare, select
# and logic operation of the kernels' expression trees:
OPS_FACE_TEST = 48    # one (pixel, face) test of sweep_math.cuh
OPS_HIT = 72          # one (tile, face) bbox + half-plane cull of K4
OPS_PIXEL_SCAN = 2    # one (face slot, pixel) id compare pair of K3/K9
OPS_POSITION_HIT = 31  # the position sums of one matching pixel
OPS_PREPASS_BASE = 100  # per pixel of K2, plus 22 per shaded channel
OPS_SHADE_BASE = 14   # per pixel of K8's shading, plus 6 per channel
OPS_ACCUM_SCAN = 1    # one (row, pixel) id compare of K11
OPS_ACCUM_MATCH = 6   # the four sums of one matching pixel of K11
PATH_KERNELS = {
    "blocks": ("face_table", "hit_plane", "build_runs", "raster_sweep",
               "grad_prepass", "grad_reduce"),
    "dense": ("face_table", "dense_sweep", "grad_prepass",
              "dense_grad_reduce"),
    "pallas": ("face_table", "pallas_raster", "hit_plane", "grad_prepass",
               "grad_reduce"),
    "mxu": ("face_table", "hit_plane", "raster_sweep", "grad_prepass",
            "mxu_grad"),
    "slots": ("face_table", "hit_plane", "slot_sweep", "grad_prepass",
              "slot_grad_reduce"),
    "resident": ("face_table", "hit_plane", "resident_sweep",
                 "grad_prepass", "grad_reduce"),
    "repro": ("scalar_accum",),
    "models": ("face_table", "hit_plane", "raster_sweep", "grad_prepass",
               "grad_reduce"),
    # a fit whose leaves feed only the shader: the G-buffer's forward
    "forward": ("face_table", "hit_plane", "raster_sweep"),
    # dryrun_multichip's passes: the blocks and the dense backend
    "dryrun": ("face_table", "hit_plane", "raster_sweep", "dense_sweep",
               "grad_prepass", "grad_reduce", "dense_grad_reduce"),
}
MODEL_SIZE = (640, 480)       # the samples' image (width, height)
ZOOM_RIGHT = 0.05    # the zoom scenes' projection half-width (bench: 0.25)
MODEL_TOL = 1e-4     # card vs CPU: pixels, and gradients / max |grad|


def fail(message):
    print(f"chip_smoke: FAIL: {message}", flush=True)
    sys.exit(1)


def phase(name, message):
    print(f"[{name}] {message}", flush=True)


def _cdiv(a, b):
    return -(-a // b)


# --------------------------------------------------------------------------
# Scenes (numpy from a seed, then tensors on the device)
# --------------------------------------------------------------------------

def bench_scene(batch, resolution, segments, device, right=0.25,
                distance=3.0):
    """The bench.py scene (bench.py:111-137), built with the port's
    matrices from numpy seed 0; `right` is the projection's half-width at
    the near plane (ZOOM_RIGHT zooms in: the "zoom" timing scene), and
    `distance` the view's translation along -z (0.3 puts the camera
    inside the cylinder: faces cross the camera plane)."""
    from dirt_tpu_torch import matrices
    from dirt_tpu_torch.utils import meshes
    rng = np.random.RandomState(0)
    vertices, faces = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    homogeneous = np.concatenate(
        [vertices, np.ones((vertices.shape[0], 1), np.float32)], axis=1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    view = matrices.compose(matrices.translation(t([0., 0., -distance])),
                            matrices.rodrigues(t([-0.4, 0., 0.])))
    projection = matrices.perspective_projection(
        near=0.1, far=20., right=right, aspect=1., device=device)
    rotations = matrices.rodrigues(
        t(rng.uniform(-1, 1, size=(batch, 3)).astype(np.float32)))
    clip = torch.einsum("vi,bij->bvj", t(homogeneous), rotations)
    clip = clip @ view @ projection
    colors = t(rng.uniform(size=(batch, vertices.shape[0], 3)))
    background = t(rng.uniform(size=(batch, resolution, resolution, 3)))
    faces_b = torch.as_tensor(faces, device=device).expand(
        batch, -1, -1).contiguous()
    weights = t(rng.uniform(size=(batch, resolution, resolution, 3)))
    return background, clip.contiguous(), colors, faces_b, weights


def crossing_scene(device, batch=2, size=128, num_faces=200, seed=3):
    """A random triangle soup where some vertices have w <= 0 (triangles
    crossing the camera plane)."""
    rng = np.random.RandomState(seed)
    nv = 120
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = rng.uniform(-0.5, 1.5, size=(batch, nv))
    f = rng.randint(0, nv, size=(batch, num_faces, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    w = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return t(bg), t(v), t(c), t(f, torch.int32), t(w)


def tie_scene(device, seed=5, batch=2, size=64, num_faces=60):
    """A soup whose faces all appear twice, the copy under index F + i:
    every covered fragment ties in depth with its twin, and the lower
    index must win."""
    rng = np.random.RandomState(seed)
    nv = 60
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = np.abs(v[..., 3]) + 0.5
    f = rng.randint(0, nv, size=(batch, num_faces, 3)).astype(np.int32)
    f = np.concatenate([f, f], axis=1)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return t(bg), t(v), t(c), t(f, torch.int32)


def deferred_scene(scene, seed=1):
    """The bench cylinder with samples/deferred.py's 10-channel G-buffer
    layout: mask (1), clip-space positions (xyz), albedo, unit normals
    (albedo and normals from numpy `seed`); background attributes 0."""
    _, clip, _, faces, weights = scene
    batch, num_vertices = clip.shape[:2]
    height, width = weights.shape[1:3]
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=clip.device)
    albedo = t(rng.uniform(0.2, 1.0, size=(batch, num_vertices, 3)))
    normals = rng.randn(batch, num_vertices, 3)
    normals = t(normals / np.linalg.norm(normals, axis=-1, keepdims=True))
    attributes = torch.cat([torch.ones_like(clip[..., :1]), clip[..., :3],
                            albedo, normals], dim=-1).contiguous()
    background = torch.zeros(batch, height, width, 10, device=clip.device)
    light = t([0.3, -0.5, -0.8])
    return background, clip, attributes, faces, weights, light


def make_shader(light):
    """Ambient + Lambert (relu(n . l)) on the albedo, times the mask, plus
    [0, 0, 0.3] where the mask is 0; `light` is closed over."""
    sky = torch.tensor([0., 0., 0.3], device=light.device)

    def shader(gbuffer):
        mask = gbuffer[..., :1]
        albedo, normals = gbuffer[..., 4:7], gbuffer[..., 7:10]
        lambert = torch.relu((normals * light).sum(dim=-1, keepdim=True))
        return albedo * (0.2 + lambert) * mask + sky * (1.0 - mask)
    return shader


# --------------------------------------------------------------------------
# Kernel vs plain
# --------------------------------------------------------------------------

def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def hit_work(face_data, bbox_cols, num_blocks, chunk, tiles_y, tiles_x,
             tile_h, tile_w, edge_col, *_):
    """K4's bytes and operations on a [B, NB * chunk, D] face table (its
    hit_blocks arguments): the columns it reads of each face once (the
    four bbox columns, and the nine edge coefficients where the edge cull
    is on), the [B, T, NB] bytes of block hits it writes (zero-filled
    first, once), and OPS_HIT a (tile, face) of its windows (the tiles
    its faces' bbox compares can reach, forward_blocks.hit_windows)."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    batch, num_faces = face_data.shape[:2]
    columns = 4 + (9 if edge_col is not None and edge_col >= 0 else 0)
    windows = int(fb.hit_windows(face_data, bbox_cols, num_blocks, chunk,
                                 tiles_y, tiles_x, tile_h, tile_w).sum())
    return (batch * num_faces * columns * face_data.element_size()
            + batch * tiles_y * tiles_x * num_blocks,
            windows * chunk * OPS_HIT)


def runs_work(hit, num_slots):
    """K12's bytes on the [B, R, I] bool hits under a budget of
    `num_slots`: the hit bytes, read once, and the ids it keeps, written
    once (4 bytes each)."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    kept = int(fb.build_runs_plain(hit, num_slots)[1].sum())
    return hit.numel() + 4 * kept, 0


def same_runs(tag, got, want):
    """Fails unless K12's four outputs (starts, counts, item_ids,
    dropped) are build_runs_plain's bit for bit."""
    for what, k, p in zip(("starts", "counts", "item_ids", "dropped"), got,
                          want, strict=True):
        if k.shape != p.shape or k.dtype != p.dtype:
            fail(f"{tag}: build_runs {what} is {k.dtype} {tuple(k.shape)}, "
                 f"its plain version's {p.dtype} {tuple(p.shape)}")
        if not torch.equal(k, p):
            fail(f"{tag}: build_runs {what} differ from its plain version "
                 f"in {int((k != p).sum())} of {p.numel()}")


def same_bits(a, b):
    """Equal shapes, dtypes and bits (float32 compared as int32, so NaN
    columns and the sign of zero count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def same_table(tag, got, want):
    """Fails unless K13's (table, order) are face_table_plain's bit for
    bit."""
    for what, k, p in zip(("table", "order"), got, want, strict=True):
        if not same_bits(k, p):
            bits = lambda t: (t.view(torch.int32)
                              if t.dtype == torch.float32 else t)
            differ = ("" if k.shape != p.shape else
                      f" in {int((bits(k) != bits(p)).sum())} of "
                      f"{p.numel()}")
            fail(f"{tag}: face_table {what} {k.dtype} {tuple(k.shape)} "
                 f"differs from its plain version's {p.dtype} "
                 f"{tuple(p.shape)}{differ}")


def table_work(vertices, faces, attrs, rows, spatial):
    """K13's bytes for a table of `rows` rows an image: its inputs
    (vertices, faces, attributes) read once and the rows it writes once;
    where `spatial`, also the keys the keys launch writes and the order
    the rows launch reads, 4 bytes a row each."""
    from dirt_tpu_torch.ops import forward_pallas, grad_tables
    width_d = (grad_tables._DF if attrs is None
               else forward_pallas._BASE + 3 * attrs.shape[-1])
    inputs = _nbytes(vertices, faces, *([] if attrs is None else [attrs]))
    return (inputs + faces.shape[0] * rows * (4 * width_d
                                              + (8 if spatial else 0)), 0)


def segment_sum(planes, clip, faces, channels):
    """The per-face gradient rows of parts "all" ([B*F, 3 * (3 + C)], by
    original face) as a segment sum, the library form of the sums K3 and
    K9 reduce: from the plain pre-pass's [B, NP, H, W] planes, each
    covered pixel's position terms keyed by its post-dilation face and its
    colour terms by its pre-dilation face, summed by torch.index_add."""
    from dirt_tpu_torch.ops import grad_dense
    batch, num_faces = faces.shape[:2]
    _, L = grad_dense.plane_layout("all", channels)
    plane = lambda i: planes[:, i]                          # [B, H, W]
    b = torch.arange(batch, device=planes.device)[:, None, None]
    face_d = plane(L["face_d"]).long()
    face_pre = plane(L["face_pre"]).long()
    corner_ids = faces.long()[b, face_d.clamp(min=0)]        # [B, H, W, 3]
    corners = clip[b[..., None], corner_ids]                 # [B,H,W,3,4]
    bd = planes[:, L["bary_d"]:L["bary_d"] + 3].movedim(1, -1)
    cx = (bd * corners[..., 0]).sum(-1)
    cy = (bd * corners[..., 1]).sum(-1)
    p = plane(L["px"]) * cx + plane(L["py"]) * cy
    pos = torch.stack([bd * plane(L["ax"])[..., None],
                       bd * plane(L["ay"])[..., None],
                       -bd * p[..., None]], dim=-1)         # [B,H,W,3,3]
    bp = planes[:, L["bary_pre"]:L["bary_pre"] + 3].movedim(1, -1)
    grad = planes[:, L["grad"]:L["grad"] + channels].movedim(1, -1)
    col = bp[..., :, None] * grad[..., None, :]             # [B,H,W,3,C]
    zeros = lambda n: torch.zeros(*pos.shape[:-1], n, device=pos.device)
    d_out = 3 * (3 + channels)
    rows = torch.cat([torch.cat([pos, zeros(channels)], -1).reshape(-1, d_out)
                      [face_d.reshape(-1) >= 0],
                      torch.cat([zeros(3), col], -1).reshape(-1, d_out)
                      [face_pre.reshape(-1) >= 0]])
    key = lambda f: (f + b * num_faces).reshape(-1)[f.reshape(-1) >= 0]
    keys = torch.cat([key(face_d), key(face_pre)])
    base = torch.zeros(batch * num_faces, d_out, device=planes.device)
    return torch.index_add(base, 0, keys, rows)


def masked_matmul(face_ids, ids, values, chunk):
    """The library form of K10's sums: for every (image, band, chunk) item,
    the {0, 1} masks of the chunk's face ids against the band's post- and
    pre-dilation ids ([2 * chunk, PIX], built from the same ids), times
    the band's float32 value planes (values [B, bands, P, PIX]), as one
    batched float32 matmul (TF32 off).  Dead chunks are computed too
    (their masks are all zero unless a listed face misses the band)."""
    batch, bands, _, pix = ids.shape
    fid = face_ids.reshape(batch, bands, -1, chunk, 1)       # [B,T,NC,K,1]
    post, pre = ids[:, :, None, 0:1], ids[:, :, None, 1:2]   # [B,T,1,1,PIX]
    masks = torch.cat([post == fid, pre == fid], dim=3).to(torch.float32)
    return torch.matmul(masks, values[:, :, None].transpose(-1, -2))


def csr_tiles(starts, counts, tile_ids):
    """The tile ids the CSR runs visit: tile_ids[starts[r] : starts[r] +
    counts[r]] for each run r, in order."""
    counts = counts.long()
    arange = lambda n: torch.arange(n, device=counts.device)
    run = torch.repeat_interleave(arange(counts.numel()), counts)
    first = torch.cumsum(counts, 0) - counts
    return tile_ids[starts.long()[run] + arange(run.numel()) - first[run]]


def tile_pixels(tiles, height, width, tile_h, tile_w):
    """The image's pixels in the distinct tiles of `tiles` (batch-folded
    ids of tile_h x tile_w tiles, row-major in each image)."""
    tiles_x = _cdiv(width, tile_w)
    t = torch.unique(tiles).long() % (_cdiv(height, tile_h) * tiles_x)
    rows = (height - t // tiles_x * tile_h).clamp(max=tile_h)
    cols = (width - t % tiles_x * tile_w).clamp(max=tile_w)
    return int((rows * cols).sum())


def union_pixels(windows, live, tile_h, tile_w):
    """The pixels in the union of the live slots' windows of each tile
    (grad_dense.face_windows of [B*T, slots] slots), summed over the
    tiles: each covered pixel once."""
    from dirt_tpu_torch.ops import grad_dense
    keep = live & (grad_dense.window_pixels(windows) > 0)
    w = windows[keep]
    run = torch.nonzero(keep)[:, 0]
    # Each window adds one over its rectangle: corner marks, then two
    # running sums.
    marks = torch.zeros(windows.shape[0], tile_h + 1, tile_w + 1,
                        dtype=torch.int32, device=windows.device)
    one = torch.ones_like(run, dtype=torch.int32)
    for r, c, sign in ((w[:, 0], w[:, 2], 1), (w[:, 0], w[:, 3] + 1, -1),
                       (w[:, 1] + 1, w[:, 2], -1),
                       (w[:, 1] + 1, w[:, 3] + 1, 1)):
        marks.index_put_((run, r, c), sign * one, accumulate=True)
    cover = marks.cumsum(1).cumsum(2)[:, :tile_h, :tile_w]
    return int((cover > 0).sum())


def repro_reference(planes, ids, counts, chunk):
    """repro/mosaic_scalar_smem_accum.py's numpy `reference`, row by row,
    with the rows at or past a tile's count left zero (the kernel's loop
    bound): [T, N / chunk, chunk, 4] from planes [T, 3, H, W], ids [T, 1,
    N] and counts [T, 1, 1, 1]."""
    tiles, num_ids = planes.shape[0], ids.shape[-1]
    out = np.zeros((tiles, num_ids // chunk, chunk, 4), np.float32)
    for t in range(tiles):
        a, b, pid = planes[t]
        for row in range(min(int(counts.reshape(-1)[t]), num_ids)):
            mask = pid == ids[t, 0, row]
            ma, mb = np.where(mask, a, 0), np.where(mask, b, 0)
            out[t, row // chunk, row % chunk] = [
                ma.sum(), mb.sum(), (ma * b).sum(), -(mb * a).sum()]
    return out


def accum_bmm(planes, ids, counts, chunk):
    """The library form of K11's rows: the {0, 1} masks of each tile's
    live ids against its id plane ([T, N, PIX]) times its value planes
    (a, b, a * b, -(b * a): [T, PIX, 4]), as one float32 bmm (TF32 off)."""
    tiles = planes.shape[0]
    flat = planes.reshape(tiles, 3, -1)
    a, b, pid = flat[:, 0], flat[:, 1], flat[:, 2]
    ids = ids.reshape(tiles, -1)
    live = (torch.arange(ids.shape[1], device=ids.device)[None]
            < counts.reshape(tiles, 1))
    masks = ((pid[:, None, :] == ids[..., None]) & live[..., None]).float()
    values = torch.stack([a, b, a * b, -(b * a)], dim=-1)
    return torch.bmm(masks, values).reshape(tiles, -1, chunk, 4)


def kernel_inputs(scene):
    """Runs the paths' stages on `scene`; returns, per kernel, a pair
    (kernel call, plain call) of zero-argument functions on the same
    inputs, the bytes and operations of its bound, and the call of the
    PyTorch library function that computes the same sums, if any."""
    from dirt_tpu_torch.ops import (forward_blocks as fb, forward_dense,
                                    forward_pallas, grad_blocks as gb,
                                    grad_dense, grad_mxu, prepass_fused)
    background, clip, colors, faces, weights = scene
    batch, height, width, channels = background.shape
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    tiles_y, tiles_x = _cdiv(height, th), _cdiv(width, tw)
    pix = th * tw
    table_args = (clip, faces, colors, height, width,
                  _cdiv(faces.shape[1], chunk) * chunk, (th, tw))
    table, starts, counts, block_ids, _ = fb.pack(
        clip, colors, faces, height, width, th, tw, chunk)
    # The sorted face table as the hit test sees it: [B, NB*chunk, D].
    face_data = table.reshape(batch, -1, table.shape[-1])
    hit_args = (face_data, fb._BBOX, face_data.shape[1] // chunk, chunk,
                tiles_y, tiles_x, th, tw, 0, height, width, 0)
    hits = fb.hit_blocks(*hit_args)
    runs_args = (hits, fb.slots_per_image(*hits.shape[1:]))
    sweep_args = (table, starts, counts, block_ids, channels, height, width,
                  tiles_x, tiles_y * tiles_x, th, tw)
    state_bytes = batch * tiles_y * tiles_x * (channels + 9) * pix * 4
    stable, slot_tile, slot_block, slot_dma, _ = fb.pack(
        clip, colors, faces, height, width, th, tw, chunk, slots=True)
    slot_args = (stable, slot_tile, slot_block, slot_dma, batch, channels,
                 height, width, tiles_x, tiles_y * tiles_x, th, tw)
    # K5 runs where the auto budget (a block's shared memory) admits the
    # image's table, by the path's own selection rule.
    with resident_table():
        resident_fits = fb.takes_resident(table, batch)

    dth, dtw = forward_dense.tile_shape(height, width)
    dchunk = forward_dense.CHUNK
    dtiles_y, dtiles_x = _cdiv(height, dth), _cdiv(width, dtw)
    dtable, dface_ids, dcounts, _ = forward_dense.pack(
        clip, colors, faces, height, width, dth, dtw, dchunk)
    dense_args = (dtable, dface_ids, dcounts, channels, height, width,
                  dtiles_x, dtiles_y * dtiles_x, dth, dtw, dchunk)
    dense_state_bytes = (batch * dtiles_y * dtiles_x * (channels + 9)
                         * dth * dtw * 4)
    pallas_args = (dtable, dface_ids, dcounts, background, dtiles_x,
                   dtiles_y * dtiles_x, dth, dtw, dchunk)
    # K8 writes pixels, face index, vertex ids, barycentrics and clip w.
    pallas_out_bytes = batch * height * width * (channels + 8) * 4

    pixels, aux = fb.rasterise_batch(background, clip, colors, faces)
    gh, gw, gchunk = gb.TILE_H, gb.TILE_W, gb.CHUNK
    n_planes = grad_dense.plane_layout("all", channels)[0]
    np_dma = _cdiv(n_planes, 8) * 8
    prepass_args = (pixels, weights, aux, gh, gw, np_dma)
    planes, _ = prepass_fused.plane_stack(*prepass_args)
    gtable, gstarts, gcounts, tile_ids, _ = gb.pack(
        clip, faces, height, width, gh, gw, gchunk)
    reduce_args = (gtable, planes, gstarts, gcounts, tile_ids, channels,
                   "all")
    _, slot_run, slot_item, gslot_dma, _ = gb.pack(
        clip, faces, height, width, gh, gw, gchunk, slots=True)
    slot_reduce_args = (gtable, planes, slot_run, slot_item, gslot_dma,
                        channels, "all")
    d_out = grad_dense.d_out_for("all", channels)

    dgh, dgw, dgchunk = grad_dense.TILE_H, grad_dense.TILE_W, grad_dense.CHUNK
    dplanes, _ = prepass_fused.plane_stack(pixels, weights, aux, dgh, dgw,
                                           np_dma)
    dgtable, dgface_ids, dgcounts, _ = grad_dense.pack(
        clip, faces, height, width, dgh, dgw, dgchunk)
    dgrad_args = (dgtable, dgface_ids, dgcounts, dplanes, channels, "all",
                  dgchunk, height, width, dgh, dgw)
    # K9 scans each live slot's window (its face's bbox clipped to the
    # tile): the windows' pixels, and the planes of their union.
    dlive = (torch.arange(dgface_ids.shape[1], device=dgcounts.device)[None]
             // dgchunk * dgchunk < dgcounts[:, None])
    windows = grad_dense.face_windows(*dgrad_args[:2], height, width, dgh,
                                      dgw)
    window_pixels = grad_dense.window_pixels(windows)[dlive]
    live_slots = int(dlive.sum())

    mids, mvalues, _ = grad_mxu.band_planes(pixels, weights, aux)
    num_bands, mchunk = _cdiv(height, grad_mxu.BAND_H), grad_mxu.CHUNK
    mface_ids, mcounts, _ = grad_mxu._pack_grad_bands(
        clip, faces, height, width,
        max(1, _cdiv(forward_pallas.tile_face_cap(faces.shape[1]), mchunk)),
        num_bands)
    mxu_args = (mface_ids, mcounts, mids, grad_mxu.split_bf16(mvalues),
                mchunk)
    ncols, mpix = mvalues.shape[-2], mvalues.shape[-1]
    live_items = int(_cdiv(mcounts, mchunk).sum())
    mxu_rows_bytes = mface_ids.numel() * 2 * ncols * 4
    # The mask's non-zero entries: a covered pixel matches one listed face
    # before and one after the dilation.
    mxu_matches = int((mids >= 0).sum())
    # Pixels each reduction matches: one face per covered pixel, before
    # (colour) and after (position) the dilation.
    n_pos = int((planes[:, 7] >= 0).sum())
    n_col = int((aux.face_index >= 0).sum())
    matches = n_pos * OPS_POSITION_HIT + n_col * 6 * channels
    # The planes of the image (the stack's zero pad plane is the kernels'
    # layout, not the function's input), which K2 writes.  A reduction
    # needs the planes of the tiles its runs visit, each tile once; the
    # bound with the whole image's planes, the looser figure of older
    # records, is printed beside its bound.
    plane_bytes = batch * height * width * n_planes * 4
    block_tiles = (height, width, gh, gw)
    dense_tiles = (height, width, dgh, dgw)
    reduce_planes = {name: tile_pixels(tiles, *shape) * n_planes * 4
                     for name, tiles, shape in (
                         ("grad_reduce",
                          csr_tiles(gstarts, gcounts, tile_ids), block_tiles),
                         ("slot_grad_reduce", gslot_dma[slot_item >= 0],
                          block_tiles))}
    reduce_planes["dense_grad_reduce"] = (
        union_pixels(windows, dlive, dgh, dgw) * n_planes * 4)
    flat_planes = grad_dense.prepass_and_planes(pixels, weights, aux,
                                                "all")[0]
    library = lambda: segment_sum(flat_planes, clip, faces, channels)

    visits = int(counts.sum())
    listed = int(dcounts.sum())
    work = {
        "face_table": table_work(*table_args[:3], table_args[5], True),
        "hit_plane": hit_work(*hit_args),
        "build_runs": runs_work(*runs_args),
        "raster_sweep": (_nbytes(table, starts, counts) + visits * 4
                         + state_bytes,
                         visits * chunk * pix * OPS_FACE_TEST),
        "resident_sweep": (_nbytes(table, starts, counts) + visits * 4
                           + state_bytes,
                           visits * chunk * pix * OPS_FACE_TEST),
        # The slot arrays in place of the runs; the live slots' visits.
        "slot_sweep": (_nbytes(stable, slot_tile, slot_block, slot_dma)
                       + state_bytes,
                       int((slot_block >= 0).sum()) * chunk * pix
                       * OPS_FACE_TEST),
        "dense_sweep": (_nbytes(dtable, dcounts) + listed * 4
                        + dense_state_bytes,
                        listed * dth * dtw * OPS_FACE_TEST),
        "grad_prepass": (_nbytes(pixels, weights, aux.barycentric,
                                 aux.indices, aux.clip_w, aux.face_index)
                         + plane_bytes + batch * height * width,
                         batch * height * width
                         * (OPS_PREPASS_BASE + 22 * channels)),
        "grad_reduce": (_nbytes(gtable, gstarts, gcounts)
                        + reduce_planes["grad_reduce"]
                        + int(gcounts.sum()) * 4
                        + gtable.shape[0] * gchunk * d_out * 4,
                        int(gcounts.sum()) * gchunk * gh * gw
                        * OPS_PIXEL_SCAN + matches),
        "slot_grad_reduce": (_nbytes(gtable, slot_run, slot_item,
                                     gslot_dma)
                             + reduce_planes["slot_grad_reduce"]
                             + gtable.shape[0] * gchunk * d_out * 4,
                             int((slot_item >= 0).sum()) * gchunk * gh * gw
                             * OPS_PIXEL_SCAN + matches),
        "dense_grad_reduce": (_nbytes(dgtable, dgcounts)
                              + reduce_planes["dense_grad_reduce"]
                              + live_slots * 4
                              + dgface_ids.numel() * d_out * 4,
                              int(window_pixels.sum()) * OPS_PIXEL_SCAN
                              + matches),
        "pallas_raster": (_nbytes(dtable, dcounts, background) + listed * 4
                          + pallas_out_bytes,
                          listed * dth * dtw * OPS_FACE_TEST
                          + batch * height * width
                          * (OPS_SHADE_BASE + 6 * channels)),
        # The products of the mask's non-zero entries with the three
        # groups' columns (a multiply-add is 2 flops), on the bf16 tensor
        # cores.
        "mxu_grad": (_nbytes(*mxu_args[:4]) + mxu_rows_bytes,
                     2 * mxu_matches * ncols * 3, PEAK_BF16_OPS_PER_MS),
    }
    calls = {
        "face_table": (lambda: fb.face_table(*table_args),
                       lambda: fb.face_table_plain(*table_args)),
        "hit_plane": (lambda: fb.hit_blocks(*hit_args),
                      lambda: fb.hit_blocks_plain(*hit_args)),
        "build_runs": (lambda: fb.build_runs(*runs_args),
                       lambda: fb.build_runs_plain(*runs_args)),
        "raster_sweep": (lambda: fb.raster_sweep(*sweep_args),
                         lambda: fb.raster_sweep_plain(*sweep_args)),
        "slot_sweep": (lambda: fb.slot_sweep(*slot_args),
                       lambda: fb.slot_sweep_plain(*slot_args)),
        "dense_sweep": (lambda: forward_dense.dense_sweep(*dense_args),
                        lambda: forward_dense.dense_sweep_plain(*dense_args)),
        "grad_prepass": (lambda: prepass_fused.plane_stack(*prepass_args),
                         lambda: prepass_fused.plane_stack_plain(
                             *prepass_args)),
        "grad_reduce": (lambda: gb.grad_reduce(*reduce_args),
                        lambda: gb.grad_reduce_plain(*reduce_args)),
        "slot_grad_reduce": (
            lambda: gb.slot_grad_reduce(*slot_reduce_args),
            lambda: gb.slot_grad_reduce_plain(*slot_reduce_args)),
        "dense_grad_reduce": (
            lambda: grad_dense.dense_grad_reduce(*dgrad_args),
            lambda: grad_dense.dense_grad_reduce_plain(*dgrad_args)),
        "pallas_raster": (
            lambda: forward_pallas.pallas_raster(*pallas_args),
            lambda: forward_pallas.pallas_raster_plain(*pallas_args)),
        "mxu_grad": (lambda: grad_mxu.mxu_grad(*mxu_args),
                     lambda: grad_mxu.mxu_grad_plain(*mxu_args)),
    }
    if resident_fits:
        calls["resident_sweep"] = (
            lambda: fb.resident_sweep(*sweep_args),
            lambda: fb.resident_sweep_plain(*sweep_args))
    libraries = {"grad_reduce": library, "dense_grad_reduce": library,
                 "slot_grad_reduce": library,
                 "mxu_grad": lambda: masked_matmul(mface_ids, mids, mvalues,
                                                   mchunk)}
    finalize = lambda state, tile_h, tile_w: forward_dense.finalize(
        state.reshape(batch, -1, channels + 9, tile_h * tile_w), background,
        height, width, _cdiv(height, tile_h), _cdiv(width, tile_w),
        tile_h=tile_h, tile_w=tile_w)[0]
    prepass = lambda: (prepass_fused.plane_stack(*prepass_args),
                       prepass_fused.plane_stack_plain(*prepass_args))
    all_planes = {name: (work[name][0] - nbytes + plane_bytes, work[name][1])
                  for name, nbytes in reduce_planes.items()}
    return calls, dict(work=work, all_planes=all_planes, libraries=libraries,
                       channels=channels, finalize=finalize, prepass=prepass,
                       reduce_args=reduce_args, visits=gcounts,
                       sweep_args=sweep_args, sweep_visits=counts,
                       list_faces=dcounts,
                       window_pixels=window_pixels, live_items=live_items,
                       live_bands=int((mcounts > 0).sum()), sweep_tiles={
                           "raster_sweep": (th, tw),
                           "slot_sweep": (th, tw),
                           "resident_sweep": (th, tw),
                           "dense_sweep": (dth, dtw)})


def compare_kernels(tag, scene):
    """Holds each kernel against its plain version on `scene`; returns
    ({name: max |kernel - plain|}, the calls and facts of kernel_inputs)."""
    calls, info = kernel_inputs(scene)
    errors = {}

    table_k, table_p = (f() for f in calls["face_table"])
    torch.cuda.synchronize()
    same_table(tag, table_k, table_p)
    errors["face_table"] = 0.0

    keep_k, keep_p = (f() for f in calls["hit_plane"])
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        fail(f"{tag}: hit_plane differs from its plain version in "
             f"{int((keep_k != keep_p).sum())} of {keep_k.numel()} entries")
    errors["hit_plane"] = _max_abs(keep_k, keep_p)
    runs_k, runs_p = (f() for f in calls["build_runs"])
    torch.cuda.synchronize()
    same_runs(tag, runs_k, runs_p)
    errors["build_runs"] = 0.0

    channels = info["channels"]
    finalized, states = {}, {}
    sweeps = [name for name in ("raster_sweep", "slot_sweep",
                                "resident_sweep", "dense_sweep")
              if name in calls]
    for name in sweeps:
        state_k, state_p = (f() for f in calls[name])
        torch.cuda.synchronize()
        for what, rows in (("winner map", slice(channels + 8, channels + 9)),
                           ("depth", slice(channels + 7, channels + 8)),
                           ("vertex ids", slice(channels + 4, channels + 7)),
                           ("state", slice(None))):
            if not torch.equal(state_k[:, rows], state_p[:, rows]):
                fail(f"{tag}: {name} {what} differs from its plain version")
        tile = info["sweep_tiles"][name]
        finalized[name] = info["finalize"](state_k, *tile)
        if not torch.equal(finalized[name], info["finalize"](state_p, *tile)):
            fail(f"{tag}: {name} pixels differ after finalize")
        errors[name] = _max_abs(state_k, state_p)
        states[name] = state_k
    for name in sweeps[1:-1]:
        # The other schedules visit the same blocks in the same order.
        if not torch.equal(states[name], states["raster_sweep"]):
            fail(f"{tag}: {name} state differs from raster_sweep's (max "
                 f"{_max_abs(states[name], states['raster_sweep'])})")
    for name in ("raster_sweep", "slot_sweep", "resident_sweep"):
        if name not in calls:
            continue
        again = calls[name][0]()
        torch.cuda.synchronize()
        if not torch.equal(again, states[name]):
            fail(f"{tag}: {name} state differs between two calls (max "
                 f"{_max_abs(again, states[name])})")

    outs_k, outs_p = (f() for f in calls["pallas_raster"])
    again = calls["pallas_raster"][0]()
    torch.cuda.synchronize()
    for what, k, p, a in zip(("pixels", "face index", "vertex ids",
                              "barycentrics", "clip w"), outs_k, outs_p,
                             again, strict=True):
        if not torch.equal(k, p):
            fail(f"{tag}: pallas_raster {what} differ from its plain version "
                 f"(max {_max_abs(k, p)})")
        if not torch.equal(a, k):
            fail(f"{tag}: pallas_raster {what} differ between two calls")
    if not torch.equal(outs_k[0], finalized["dense_sweep"]):
        fail(f"{tag}: pallas_raster pixels differ from dense_sweep's after "
             f"finalize")
    errors["pallas_raster"] = max(_max_abs(k, p)
                                  for k, p in zip(outs_k, outs_p))

    (planes_k, dil_k), (planes_p, dil_p) = (f() for f in calls["grad_prepass"])
    torch.cuda.synchronize()
    if not torch.equal(planes_k, planes_p):
        fail(f"{tag}: grad_prepass planes differ from the plain version "
             f"(max {_max_abs(planes_k, planes_p)})")
    if not torch.equal(dil_k, dil_p):
        fail(f"{tag}: grad_prepass dilation mask differs")
    errors["grad_prepass"] = _max_abs(planes_k, planes_p)
    dilated = {"axial": int(dil_k.sum())}
    with diagonal_dilation():
        (planes_k, dil_k), (planes_p, dil_p) = info["prepass"]()
        torch.cuda.synchronize()
    if not (torch.equal(planes_k, planes_p) and torch.equal(dil_k, dil_p)):
        fail(f"{tag}: grad_prepass with the diagonal attempts differs from "
             f"its plain version (max {_max_abs(planes_k, planes_p)})")
    dilated["diagonal"] = int(dil_k.sum())

    rel, rows = {}, {}
    for name in ("grad_reduce", "slot_grad_reduce", "dense_grad_reduce",
                 "mxu_grad"):
        rows_k, rows_p = (f() for f in calls[name])
        torch.cuda.synchronize()
        rel[name] = (_max_abs(rows_k, rows_p)
                     / max(float(rows_p.abs().max()), 1.0))
        if not rel[name] <= ROW_TOL:
            fail(f"{tag}: {name} rows differ by {rel[name]} > {ROW_TOL}")
        errors[name] = _max_abs(rows_k, rows_p)
        rows[name] = rows_k
    if not torch.equal(rows["slot_grad_reduce"], rows["grad_reduce"]):
        fail(f"{tag}: slot_grad_reduce rows differ from grad_reduce's (max "
             f"{_max_abs(rows['slot_grad_reduce'], rows['grad_reduce'])})")
    resident = ("K5 resident_sweep == (state, pixels; state == K1's; == "
                "in two calls)" if "resident_sweep" in calls else
                "K5 not run (the image's table exceeds a block's shared "
                "memory)")
    phase("kernels", f"{tag}: K13 face_table == (table and order, as "
          f"bits), K4 hit_plane ==, K12 build_runs == "
          f"(starts, counts, ids, dropped), K1 raster_sweep == (and "
          f"== in two calls), K5b slot_sweep == (state, pixels; state == "
          f"K1's; == in two calls), {resident}, K7 "
          f"dense_sweep == (state, pixels), K8 pallas_raster == (pixels, "
          f"aux; pixels == K7's; == in two calls), K2 grad_prepass == (also "
          f"with the "
          f"diagonal attempts; dilated pixels {dilated}), K3 grad_reduce "
          f"rel {rel['grad_reduce']:.2e}, K6 slot_grad_reduce rel "
          f"{rel['slot_grad_reduce']:.2e} (rows == K3's), K9 "
          f"dense_grad_reduce rel {rel['dense_grad_reduce']:.2e}, K10 "
          f"mxu_grad rel {rel['mxu_grad']:.2e} OK")
    return errors, calls, info


def edge_runs(reduce_args):
    """K3's and K6's inputs for four runs on the first four face blocks of
    `reduce_args` (grad_reduce's arguments): 0, 1, VISIT_LIST + 300 and
    37 visits over tiles of every image (ids 7 apart).  Returns (the CSR
    arguments, the slot arguments); the slot form gives every run a
    leading no-op slot and one after every fifth visit."""
    from dirt_tpu_torch.ops import grad_blocks as gb
    table, planes, _, _, _, channels, parts = reduce_args
    lengths = (0, 1, gb.VISIT_LIST + 300, 37)
    num_tiles = planes.shape[0]
    tile_ids, slot_run, slot_item, slot_dma = [], [], [], []
    for run, n in enumerate(lengths):
        slot_run.append(run)
        slot_item.append(-1)
        slot_dma.append(0)
        for i in range(n):
            tile = (7 * i + 3 * run) % num_tiles
            tile_ids.append(tile)
            slot_run.append(run)
            slot_item.append(tile)
            slot_dma.append(tile)
            if i % 5 == 4:
                slot_run.append(run)
                slot_item.append(-1)
                slot_dma.append(0)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=planes.device)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    runs = table[:len(lengths)].contiguous()
    return ((runs, planes, i32(starts.tolist()), i32(lengths), i32(tile_ids),
             channels, parts),
            (runs, planes, i32(slot_run), i32(slot_item), i32(slot_dma),
             channels, parts))


def check_reduce_walk(tag, calls, info):
    """K3 and K6, the face-major run walk: each gives equal rows in two
    calls on `tag`'s inputs; on edge_runs K6 == K3 bit for bit, both
    within ROW_TOL of their plain versions, the empty run's rows zero and
    the long run's not."""
    from dirt_tpu_torch.ops import grad_blocks as gb
    for name in ("grad_reduce", "slot_grad_reduce"):
        first, second = calls[name][0](), calls[name][0]()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"{tag}: {name} rows differ between two calls (max "
                 f"{_max_abs(first, second)})")
    csr, slot = edge_runs(info["reduce_args"])
    k3, k6 = gb.grad_reduce(*csr), gb.slot_grad_reduce(*slot)
    torch.cuda.synchronize()
    if not torch.equal(k6, k3):
        fail(f"{tag}: on the edge runs slot_grad_reduce differs from "
             f"grad_reduce (max {_max_abs(k6, k3)})")
    want = gb.grad_reduce_plain(*csr)
    rel = {}
    for name, got, plain in (("grad_reduce", k3, want), (
            "slot_grad_reduce", k6, gb.slot_grad_reduce_plain(*slot))):
        rel[name] = _max_abs(got, plain) / max(float(plain.abs().max()), 1.)
        if not rel[name] <= ROW_TOL:
            fail(f"{tag}: {name} on the edge runs differs from its plain "
                 f"version by {rel[name]} > {ROW_TOL}")
    if bool(k3[0].any()) or not bool(k3[2].any()):
        fail(f"{tag}: edge runs: the empty run's rows are not zero or the "
             f"long run's are")
    lengths = csr[3].tolist()
    phase("kernels", f"{tag}: K3 and K6 each == in two calls; runs of "
          f"{lengths} visits (list of {gb.VISIT_LIST}): K6 == K3, rel "
          f"{rel['grad_reduce']:.2e} vs plain, empty run zero OK")


def sweep_edge_runs(sweep_args):
    """K1's and K5b's inputs on one image of `sweep_args` (raster_sweep's
    arguments): the image of the busiest run, whose three busiest tiles
    take runs of 1, 121 and SweepShape.list + 100 visits (more than the
    staging area and more than the visit list hold), each visiting the
    image's face blocks in turn, ascending and repeating; every other run
    takes none.  Returns (the CSR arguments, the slot arguments, the
    lengths); the slot form gives each listed run a leading no-op slot and
    one after every fifth visit, and the other runs no slot."""
    from dirt_tpu_torch.ops import _cuda, forward_blocks as fb
    table, _, counts, _, channels, height, width, tiles_x, num_tiles, th, \
        tw = sweep_args
    per_image = table.shape[0] // (counts.shape[0] // num_tiles)
    image = int(counts.argmax()) // num_tiles
    own = counts[image * num_tiles:(image + 1) * num_tiles]
    tiles = torch.argsort(own, descending=True, stable=True)[:3].tolist()
    shape = fb.sweep_shape(th * tw, table.shape[1],
                           _cuda.shared_memory_optin(table.device))
    lengths = dict(zip(tiles, (1, 121, shape.list + 100)))
    starts, run_counts, ids = [], [], []
    slot_tile, slot_block, slot_dma = [], [], []
    for tile in range(num_tiles):
        n = lengths.get(tile, 0)
        starts.append(len(ids))
        run_counts.append(n)
        ids += [i % per_image for i in range(n)]
        if n:
            slot_tile.append(tile)
            slot_block.append(-1)
            slot_dma.append(0)
        for i in range(n):
            slot_tile.append(tile)
            slot_block.append(i % per_image)
            slot_dma.append(i % per_image)
            if i % 5 == 4:
                slot_tile.append(tile)
                slot_block.append(-1)
                slot_dma.append(0)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=table.device)
    own_table = table[image * per_image:(image + 1) * per_image].contiguous()
    geometry = (channels, height, width, tiles_x, num_tiles, th, tw)
    return ((own_table, i32(starts), i32(run_counts), i32(ids), *geometry),
            (own_table, i32(slot_tile), i32(slot_block), i32(slot_dma), 1,
             *geometry),
            [lengths[t] for t in tiles])


def check_sweep_walk(tag, info):
    """K1 and K5b, the run walk: on sweep_edge_runs each equals its plain
    version and K5b == K1 bit for bit; the runs without a visit are
    background and the listed runs are not."""
    from dirt_tpu_torch.ops import forward_blocks as fb, forward_dense
    csr, slot, lengths = sweep_edge_runs(info["sweep_args"])
    k1, k5b = fb.raster_sweep(*csr), fb.slot_sweep(*slot)
    torch.cuda.synchronize()
    if not torch.equal(k1, fb.raster_sweep_plain(*csr)):
        fail(f"{tag}: on the edge runs raster_sweep differs from its plain "
             f"version")
    # Every listed run cut into pieces of one and two visits.
    for piece in (1, 2):
        if not torch.equal(fb.raster_sweep(*csr, piece=piece), k1):
            fail(f"{tag}: on the edge runs raster_sweep in pieces of "
                 f"{piece} visits differs from its plain version")
    if not torch.equal(k5b, k1) or not torch.equal(
            fb.slot_sweep_plain(*slot), k1):
        fail(f"{tag}: on the edge runs slot_sweep or its plain version "
             f"differs from raster_sweep (max {_max_abs(k5b, k1)})")
    listed = csr[2] > 0
    init = forward_dense.init_state(info["channels"], k1.shape[2],
                                    device=k1.device)
    empty = int((~listed).sum())
    # The 121-visit run, on the second busiest tile, covers pixels.
    covered = bool((k1[csr[2] == 121, -1] >= 0).any())
    if not (torch.equal(k1[~listed], init.expand(empty, -1, -1))
            and covered):
        fail(f"{tag}: edge runs: the {empty} runs without a visit are not "
             f"background, or the 121-visit run covers nothing")
    phase("kernels", f"{tag}: K1 (also in pieces of 1 and 2 visits) and "
          f"K5b on runs of {lengths} visits and {empty} of none: == their "
          f"plain versions, K5b == K1, empty runs background OK")


def check_list_walk(tag, scene, lengths=(3728, 301, 1)):
    """K7 and K8 on the run walk: image 0's three busiest tiles of `scene`
    (the dense packing) take lists of `lengths` faces, each the first
    entries of its own list (hits first; at most the slots) followed by
    the list's faces that miss the tile, every other tile none.  K8's five
    outputs == its plain version's bit for bit and == themselves in a
    second call; the tiles without a list are background.  K7's state ==
    its plain version's (which sweeps each list's live chunks, the
    following misses included) under torch.equal and == itself in a
    second call, and its pixels after finalize == K8's.  Returns the
    lengths."""
    from dirt_tpu_torch.ops import (_cuda, forward_blocks as fb,
                                    forward_dense, forward_pallas)
    background, clip, colors, faces, _ = scene
    batch, height, width, channels = background.shape
    th, tw = forward_dense.tile_shape(height, width)
    chunk = forward_dense.CHUNK
    tiles_x = _cdiv(width, tw)
    tiles_y = _cdiv(height, th)
    num_tiles = tiles_y * tiles_x
    table, face_ids, counts, _ = forward_dense.pack(
        clip, colors, faces, height, width, th, tw, chunk)
    tiles = torch.argsort(counts[:num_tiles], descending=True,
                          stable=True)[:len(lengths)].tolist()
    edge = torch.zeros_like(counts)
    face_ids = face_ids.clone()
    for tile, n in zip(tiles, lengths):
        n = min(n, face_ids.shape[1])
        edge[tile] = n
        hits = int(counts[tile])
        if n < hits:
            # The misses after the first n hits, so that dense_sweep_plain's
            # live-chunk tail covers nothing, as in a packed list.
            row = face_ids[tile]
            face_ids[tile] = torch.cat([row[:n], row[hits:], row[n:hits]])
    args = (table, face_ids, edge, background, tiles_x, num_tiles, th, tw,
            chunk)
    got = forward_pallas.pallas_raster(*args)
    again = forward_pallas.pallas_raster(*args)
    want = forward_pallas.pallas_raster_plain(*args)
    dense_args = (table, face_ids, edge, channels, height, width, tiles_x,
                  num_tiles, th, tw, chunk)
    k7 = forward_dense.dense_sweep(*dense_args)
    k7_again = forward_dense.dense_sweep(*dense_args)
    k7_plain = forward_dense.dense_sweep_plain(*dense_args)
    torch.cuda.synchronize()
    for what, k, a, p in zip(("pixels", "face index", "vertex ids",
                              "barycentrics", "clip w"), got, again, want,
                             strict=True):
        if not (torch.equal(k, p) and torch.equal(a, k)):
            fail(f"{tag}: on lists of {edge[tiles].tolist()} faces "
                 f"pallas_raster {what} differ from its plain version (max "
                 f"{_max_abs(k, p)}) or between two calls")
    if not (torch.equal(k7, k7_plain) and torch.equal(k7_again, k7)):
        fail(f"{tag}: on lists of {edge[tiles].tolist()} faces dense_sweep "
             f"differs from its plain version (max {_max_abs(k7, k7_plain)})"
             f" or between two calls")
    k7_pixels = forward_dense.finalize(
        k7.reshape(batch, num_tiles, channels + 9, th * tw), background,
        height, width, tiles_y, tiles_x, tile_h=th, tile_w=tw)[0]
    if not torch.equal(k7_pixels, got[0]):
        fail(f"{tag}: on the edge lists dense_sweep's pixels differ from "
             f"pallas_raster's after finalize")
    rows = torch.arange(height, device=edge.device)[:, None] // th
    cols = torch.arange(width, device=edge.device)[None, :] // tw
    unlisted = edge[:num_tiles][rows * tiles_x + cols] == 0
    index = got[1]
    if not (bool((index[0][unlisted] == -1).all())
            and bool((index[1:] == -1).all())
            and bool((index[0][~unlisted] >= 0).any())):
        fail(f"{tag}: the tiles without a list are not background, or the "
             f"listed tiles cover nothing")
    shape = fb.sweep_shape(th * tw, 1, _cuda.shared_memory_optin(
        table.device))
    listed = edge[tiles].tolist()
    phase("kernels", f"{tag}: K8 pallas_raster and K7 dense_sweep on lists "
          f"of {listed} faces and 0 (a visit list of {shape.list}, staging "
          f"for {shape.cap}): == their plain versions and in two calls, K7's "
          f"pixels == K8's, unlisted tiles background OK")
    return listed


def hit_tables(scene):
    """K4's inputs (hit_blocks' arguments) on `scene` as the packs give
    them: the forward pack's face table [B, NB * chunk, D] (bbox columns,
    edge coefficients from column 0, dilate 0) and the gradient pack's
    (its bbox columns, edges from column 12, dilate 1), with the block
    and tile grid."""
    from dirt_tpu_torch.ops import forward_blocks as fb, grad_blocks as gb
    background, clip, colors, faces, _ = scene
    batch, height, width, _ = background.shape
    table = fb.pack(clip, colors, faces, height, width, fb.TILE_H,
                    fb.TILE_W, fb.CHUNK)[0]
    gtable = gb.pack(clip, faces, height, width, gb.TILE_H, gb.TILE_W,
                     gb.CHUNK)[0]
    grid = (_cdiv(height, fb.TILE_H), _cdiv(width, fb.TILE_W), fb.TILE_H,
            fb.TILE_W)
    ggrid = (_cdiv(height, gb.TILE_H), _cdiv(width, gb.TILE_W), gb.TILE_H,
             gb.TILE_W)
    rows = lambda t: t.reshape(batch, -1, t.shape[-1])
    return {0: (rows(table), fb._BBOX, table.shape[0] // batch, fb.CHUNK,
                *grid, 0, height, width, 0),
            1: (rows(gtable), gb._BBOX, gtable.shape[0] // batch, gb.CHUNK,
                *ggrid, 12, height, width, 1)}


def rechunk(args, chunk):
    """hit_blocks' arguments `args` at another `chunk`: the table padded
    past its rows to a multiple of `chunk` with rows no bbox compare
    passes (forward_pallas._pad_row's empty bbox)."""
    from dirt_tpu_torch.ops import forward_pallas
    face_data, bbox_cols = args[:2]
    rows = face_data.shape[1]
    pad = _cdiv(rows, chunk) * chunk - rows
    if pad:
        empty = face_data[:, :1].clone()
        big = float(forward_pallas._BIG)
        for col, value in zip(bbox_cols, (big, -1.0, big, -1.0)):
            empty[..., col] = value
        face_data = torch.cat([face_data, empty.expand(-1, pad, -1)], dim=1)
    return (face_data.contiguous(), bbox_cols, (rows + pad) // chunk, chunk,
            *args[4:])


def degenerate_rows(face_data, bbox_cols, edge_col):
    """A copy of the table with rows made degenerate, three of each kind
    from row 8 on, a kind every 8 rows: empty (r1 < r0 by far, the pad
    row's), reversed by less than a tile (r1 = r0 - 3, still passing the
    compares), a NaN, +inf and -inf bound, huge finite bounds and NaN edge
    coefficients.  Needs 67 rows or more."""
    from dirt_tpu_torch.ops import forward_pallas
    fd = face_data.clone()
    r0c, r1c, c0c, c1c = bbox_cols
    big = float(forward_pallas._BIG)
    kinds = [
        {r0c: big, r1c: -1.0, c0c: big, c1c: -1.0},
        {r1c: fd[:, 9:12, r0c] - 3.0, c1c: fd[:, 9:12, c0c] - 2.0},
        {r0c: float("nan")},
        {r1c: float("inf")},
        {c0c: float("-inf"), c1c: float("inf")},
        {r0c: -3e38, r1c: 3e38},
        {c0c: 1e30, c1c: 2e30},
        {edge_col: float("nan"), edge_col + 4: float("nan")},
    ]
    for k, kind in enumerate(kinds):
        for col, value in kind.items():
            fd[:, 8 + 8 * k: 8 + 8 * k + 3, col] = value
    return fd


HIT_CHUNKS = (8, 32, 64, 128)


def check_hit_plane(scenes, ragged):
    """K4 on each of `scenes` ({tag: scene}) and on the forward table of
    scene `ragged` (a 100 x 100 image: 7 x 7 tiles) cut to 3 images and
    300 faces (ragged against the blocks and thread blocks) and to 5 faces
    of one image repeated 70,000 times (more images than a grid's y or z
    dimension holds), and on the tables of the first scene with
    degenerate_rows: the forward pack's and the gradient pack's tables,
    each padded to chunks of HIT_CHUNKS faces, at dilate 0 and 1, with its
    edge cull and without (edge_col -1): block hits and window counts ==
    its plain version's bit for bit."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    cases = {}
    for tag, scene in scenes.items():
        for dilate, args in hit_tables(scene).items():
            cases[f"{tag}, {('forward', 'gradient')[dilate]} table"] = args
    first = next(iter(scenes))
    for name in ("forward", "gradient"):
        args = cases[f"{first}, {name} table"]
        cases[f"{first} degenerate rows, {name} table"] = (
            degenerate_rows(args[0], args[1], args[8]), *args[1:])
    table, *rest = hit_tables(ragged)[0]
    cases["ragged 3x100^2x300f"] = (table[:3, :300].contiguous(), *rest)
    # More images than a grid's y or z dimension may hold.
    cases["many images 70000x100^2x5f"] = (
        table[:1, :5].expand(70000, -1, -1).contiguous(), *rest)
    kept = {}
    for tag, args in cases.items():
        for chunk in HIT_CHUNKS:
            chunked = rechunk(args, chunk)
            for dilate in (0, 1):
                for edges in (args[8], None):
                    call = (*chunked[:8], edges, *chunked[9:11], dilate)
                    counts = [torch.full(
                        (chunked[0].shape[0], chunked[2]), -1,
                        dtype=torch.int32, device=args[0].device)
                        for _ in range(2)]
                    got = fb.hit_blocks(*call, window=counts[0])
                    want = fb.hit_blocks_plain(*call, window=counts[1])
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"{tag}: hit_blocks at chunk {chunk}, dilate "
                             f"{dilate}, edges {edges}, differs from its "
                             f"plain version in "
                             f"{int((got != want).sum())} of {got.numel()}")
                    if not torch.equal(counts[0], counts[1]):
                        fail(f"{tag}: K4's window counts at chunk {chunk} "
                             f"differ from hit_windows' in "
                             f"{int((counts[0] != counts[1]).sum())} of "
                             f"{counts[0].numel()}")
        kept[tag] = tuple(args[0].shape)
    phase("kernels", f"K4 block hits, warp votes over tile windows, chunks "
          f"{HIT_CHUNKS}, on (images, faces, columns) " + "; ".join(
              f"{tag} {shape}" for tag, shape in kept.items())
          + ": at dilate 0 and 1, with and without the edge cull, hits and "
          "window counts == its plain version bit for bit OK")


def time_hit_cells(device, card_line):
    """K4 alone on the benchmark's mesh (the 65,536-face cylinder at 512^2)
    at 4 and 32 views, both packs' tables: profiler device ms of the
    kernel and of the whole call (the output's zero-fill too) and
    CUDA-event ms, beside its bound (hit_work: its [B, T, NB] bytes
    written and the table's columns read once), and the windows' share
    of the (tile, block) pairs."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    for batch in (4, 32):
        scene = bench_scene(batch, 512, 8192, device)
        parts = []
        for dilate, args in hit_tables(scene).items():
            run = lambda: fb.hit_blocks(*args)
            nbytes, ops = hit_work(*args)
            bound_ms, bound_by = bound(nbytes, ops)
            pairs = args[0].shape[0] * args[2] * args[4] * args[5]
            windows = int(fb.hit_windows(*args[:8]).sum())
            call_ms = device_profile(run, PROFILE_STEPS)[0]
            parts.append(
                f"dilate {dilate}: kernel {device_time(run, 'hit_plane'):.4f}"
                f" ms device, with the zero-fill "
                + ("not measured" if call_ms is None else f"{call_ms:.4f} ms")
                + f", {time_ms(run, STEPS):.4f} ms CUDA events, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes), windows "
                f"{100.0 * windows / pairs:.3f}% of {pairs} pairs")
        del scene
        phase("timing", f"K4 at {batch}x512^2x65536f: " + "; ".join(parts)
              + f" on {card_line}")


def time_k1_cells(device, card_line, check=True):
    """K1 alone on the benchmark's mesh (the 65,536-face cylinder at 512^2)
    at 4 and 32 views from the distant camera and at 32 from inside the
    cylinder (INSIDE_CELL's camera): the forward runs' lengths (busy runs,
    the longest, their 99th percentile, runs over SWEEP_PIECE where the
    tree has it) and the longest block (sweep_chain), profiler device ms
    of K1's launches and CUDA-event ms, beside its bound (the table, the
    runs' ids and the state, each once, or the face tests); where `check`,
    the state == raster_sweep_plain's bit for bit."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    piece = getattr(fb, "SWEEP_PIECE", None)
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    for batch, distance in ((4, 3.0), (32, 3.0), (32, 0.3)):
        background, clip, colors, faces, _ = bench_scene(
            batch, 512, 8192, device, distance=distance)
        channels = background.shape[-1]
        tiles_x = _cdiv(512, tw)
        table, starts, counts, block_ids, _ = fb.pack(
            clip, colors, faces, 512, 512, th, tw, chunk)
        args = (table, starts, counts, block_ids, channels, 512, 512,
                tiles_x, tiles_x * _cdiv(512, th), th, tw)
        del background, clip, colors, faces
        run = lambda: fb.raster_sweep(*args)
        busy = counts[counts > 0].float()
        visits = int(counts.sum())
        nbytes = (_nbytes(table, starts, counts) + visits * 4
                  + counts.shape[0] * (channels + 9) * th * tw * 4)
        bound_ms, bound_by = bound(nbytes, visits * chunk * th * tw
                                   * OPS_FACE_TEST)
        split = ("" if piece is None else
                 f", {int((counts > piece).sum())} over {piece}, the "
                 f"longest block {int(fb.sweep_chain(counts))}")
        same = ""
        if check:
            state = run()
            torch.cuda.synchronize()
            if not (torch.equal(state, fb.raster_sweep_plain(*args))
                    and torch.equal(run(), state)):
                fail(f"K1 at {batch}x512^2 (camera at {distance}) differs "
                     f"from its plain version or between two calls")
            same = ", == plain and in two calls"
            del state
        phase("timing", f"K1 raster_sweep at {batch}x512^2x65536f, camera "
              f"at {distance}: {busy.numel()} busy runs of "
              f"{counts.numel()}, visits {visits}, longest run "
              f"{int(busy.max())}, p99 {float(torch.quantile(busy, 0.99)):.1f}"
              f"{split}; {device_time(run, 'raster_sweep'):.4f} ms device, "
              f"{time_ms(run, STEPS):.4f} ms CUDA events, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes){same} on "
              f"{card_line}")
        del args, table, starts, counts, block_ids
        torch.cuda.empty_cache()


def check_build_runs(device, card_line):
    """K12 on the benchmark's hits, the 65,536-face cylinder at 32 x 512^2
    ([32, 1024, 2048]): the forward pack's runs (tiles over blocks, the
    hits as K4 writes them) and the gradient pack's (blocks over tiles,
    the transposed view of the dilated hits, read in place), each under
    the pack's budget and under one that truncates (half the first
    image's live visits): starts, counts, ids and dropped ==
    build_runs_plain's bit for bit.  Then, at the pack's budget, profiler
    device ms of the kernel's two launches and of the whole call (the
    cumsum and the zero-fill too) and CUDA-event ms of the call, beside
    its bound (runs_work at 3.35 TB/s) and the plain version's
    CUDA-event ms."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    tables = hit_tables(bench_scene(32, 512, 8192, device))
    parts = []
    for dilate, pack in ((0, "forward"), (1, "gradient")):
        hit = fb.hit_blocks(*tables[dilate])
        if dilate:
            hit = hit.transpose(1, 2)
        full = fb.slots_per_image(*hit.shape[1:])
        cut = max(1, int(hit[0].sum()) // 2)
        for budget in (full, cut):
            got = fb.build_runs(hit, budget)
            want = fb.build_runs_plain(hit, budget)
            torch.cuda.synchronize()
            same_runs(f"{pack} runs {tuple(hit.shape)} at budget {budget}",
                      got, want)
        dropped = int(want[3].sum())     # at the truncating budget
        if dropped <= 0:
            fail(f"{pack} runs: the budget {cut} truncated nothing")
        run = lambda: fb.build_runs(hit, full)
        nbytes, _ = runs_work(hit, full)
        call_ms = device_profile(run, PROFILE_STEPS)[0]
        parts.append(
            f"{pack} {tuple(hit.shape)} strides {hit.stride()}: kernel "
            f"{device_time(run, 'build_runs'):.4f} ms device (2 launches), "
            f"the call " + ("not measured" if call_ms is None
                            else f"{call_ms:.4f} ms device")
            + f", {time_ms(run, STEPS):.4f} ms CUDA events; plain "
            f"{time_ms(lambda: fb.build_runs_plain(hit, full), 5):.4f} ms; "
            f"bound {bound(nbytes, 0)[0]:.4f} ms (bytes: {nbytes}); == plain "
            f"at budgets {full} and {cut} ({dropped} dropped)")
    phase("timing", "K12 build_runs at 32x512^2x65536f: " + "; ".join(parts)
          + f" on {card_line}")


def table_edge_scene(device, channels=3, batch=2, num_faces=96, seed=7):
    """A triangle soup, 3 vertices a face, whose rows hold K13's edge
    cases: degenerate faces (a repeated vertex, coincident corners),
    corners at w = 0, w < 0, w = 1e-30 (pixel bounds past int32) and w =
    1e-45 (infinite ones), faces off the screen and NaN coordinates.
    Returns (vertices [B, V, 4], faces [B, F, 3] int32, attributes [B, V,
    `channels`])."""
    rng = np.random.RandomState(seed)
    nv = 3 * num_faces
    xy = rng.uniform(-1.2, 1.2, (batch, nv, 2))
    z = rng.uniform(-0.5, 0.9, (batch, nv, 1))
    w = rng.uniform(0.6, 2.0, (batch, nv, 1))
    v = np.concatenate([xy * w, z * w, w], -1).astype(np.float32)
    f = np.tile(np.arange(nv, dtype=np.int32).reshape(-1, 3), (batch, 1, 1))
    f[:, 0:24:4, 2] = f[:, 0:24:4, 1]          # a repeated vertex
    v[:, 3 * 5 + 2] = v[:, 3 * 5]              # coincident corners
    v[:, 72:102:3, 3] = 0.0
    v[:, 73:102:3, 3] *= -1.0
    v[:, 102:132:3, 3] = 1e-30
    v[:, 133:162:3, 3] = 1e-45
    v[:, 162:201, 0] += 5.0 * v[:, 162:201, 3]
    v[:, 201:240, 1] -= 3.0 * v[:, 201:240, 3]
    v[:, 244, 0] = np.nan
    v[:, 250, 3] = np.nan
    a = rng.uniform(size=(batch, nv, channels)).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=device)
    return t(v), t(f), t(a)


def table_cases(device, batch):
    """K13's cases ({tag: face_table's arguments before the tile}): the
    benchmark's 65,536-face cylinder at `batch` x 512^2 in both layouts
    (the forward's with 3 colour channels), and table_edge_scene at 48 x
    80 with 35 pad rows in the forward layout at C = 3, 6 and 10 and in
    the gradient's."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    _, clip, colors, faces, _ = bench_scene(batch, 512, 8192, device)
    rows = _cdiv(faces.shape[1], fb.CHUNK) * fb.CHUNK
    cases = {f"{batch}x512^2x65536f forward": (clip, faces, colors, 512,
                                               512, rows),
             f"{batch}x512^2x65536f gradient": (clip, faces, None, 512, 512,
                                                rows)}
    for channels in (3, 6, 10):
        v, f, a = table_edge_scene(device, channels)
        cases[f"edge rows C={channels}"] = (v, f, a, 48, 80, f.shape[1] + 35)
    cases["edge rows gradient"] = (v, f, None, 48, 80, f.shape[1] + 35)
    return cases


def check_tables(cases):
    """K13 on each of `cases` (table_cases), Morton-sorted at the port's
    tile and in face order: the table and order == face_table_plain's,
    two launches a sorted table and one in face order; the keys ==
    face_keys_plain's, the rows in K13's order == face_rows_plain's, all
    bit for bit (float32 as bits: NaN columns count)."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    tile = (fb.TILE_H, fb.TILE_W)
    for tag, (v, f, a, h, w, rows) in cases.items():
        for sort in (tile, None):
            name = f"{tag}, {'sorted' if sort else 'face order'}"
            fb.FACE_TABLE.launches = 0
            got = fb.face_table(v, f, a, h, w, rows, sort)
            launches = fb.FACE_TABLE.launches
            same_table(name, got, fb.face_table_plain(v, f, a, h, w, rows,
                                                      sort))
            if launches != (2 if sort else 1):
                fail(f"{name}: face_table launched K13 {launches} times")
            order = got[1] if sort else None
            if sort:
                widen = fb.table_layout(a).widen
                keys = fb.face_keys(v, f, rows, h, w, widen, *sort)
                if not torch.equal(keys, fb.face_keys_plain(
                        v, f, rows, h, w, widen, *sort)):
                    fail(f"{name}: K13's keys differ from the plain keys")
            got_rows = fb.face_rows(v, f, a, rows, h, w, order)
            if not (same_bits(got_rows, fb.face_rows_plain(
                    v, f, a, rows, h, w, order))
                    and same_bits(got_rows, got[0])):
                fail(f"{name}: K13's rows differ from the plain rows")
            torch.cuda.synchronize()
    return list(cases)


def check_table_path(scene, tag):
    """The blocks step on `scene` with K13's tables and with the plain
    path's (forward_blocks.face_table_plain on the card): pixels equal,
    gradients within GRAD_TOL (index_add_'s atomics sum the vertex rows
    in another order each run); K13 launched 4 times a step (2 a table)
    and not at all on the plain path."""
    from dirt_tpu_torch.ops import _cuda, forward_blocks as fb
    _cuda.reset_counts()
    pixels, grads = step(scene, "blocks")
    torch.cuda.synchronize()
    if fb.FACE_TABLE.launches != 4:
        fail(f"{tag}: the blocks step launched K13 "
             f"{fb.FACE_TABLE.launches} times, not 4")
    with _constants("forward_blocks", face_table=fb.face_table_plain):
        _cuda.reset_counts()
        plain_pixels, plain_grads = step(scene, "blocks")
        torch.cuda.synchronize()
        if fb.FACE_TABLE.launches != 0:
            fail(f"{tag}: the plain tables launched K13")
    if not torch.equal(pixels, plain_pixels):
        fail(f"{tag}: pixels differ between K13's tables and the plain "
             f"path's (max {_max_abs(pixels, plain_pixels)})")
    _check_grads(f"{tag} with K13's tables", [
        (name, g, p) for name, g, p in zip(
            ("background", "vertices", "colours"), grads, plain_grads)])


def check_face_table(device, card_line):
    """K13 on table_cases at F's size (32 x 512^2, 65,536 faces) and the
    edge rows (check_tables), the blocks step with K13's tables == with
    the plain path's at 4 x 512^2 (check_table_path); then, at F's size
    in both layouts, profiler device ms of the kernel's two launches and
    of the whole call (the argsort and the cast too) and CUDA-event ms of
    the call, beside its bound (table_work at 3.35 TB/s) and the plain
    path's CUDA-event ms."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    cases = table_cases(device, 32)
    checked = check_tables(cases)
    check_table_path(bench_scene(4, 512, 8192, device), "4x512^2x65536f")
    tile = (fb.TILE_H, fb.TILE_W)
    parts = []
    for tag in checked[:2]:
        args = cases[tag]
        run = lambda: fb.face_table(*args, tile)
        nbytes, _ = table_work(*args[:3], args[5], True)
        call_ms = device_profile(run, PROFILE_STEPS)[0]
        parts.append(
            f"{tag} ({tuple(run()[0].shape)}): kernel "
            f"{device_time(run, 'face_table'):.4f} ms device (2 launches), "
            f"the call " + ("not measured" if call_ms is None
                            else f"{call_ms:.4f} ms device")
            + f", {time_ms(run, STEPS):.4f} ms CUDA events; plain "
            f"{time_ms(lambda: fb.face_table_plain(*args, tile), 5):.4f} "
            f"ms; bound {bound(nbytes, 0)[0]:.4f} ms (bytes: {nbytes})")
    phase("timing", "K13 face_table == plain (table, order, keys, rows; "
          f"{', '.join(checked)}; the 4x512^2 step's pixels ==, gradients "
          f"within {GRAD_TOL}): " + "; ".join(parts) + f" on {card_line}")


def check_resident_walk(scenes):
    """K5 on the run walk: on each of `scenes` ({tag: scene}) and on the
    first with every count zeroed (every group empty), K5's state == its
    plain version's == K1's bit for bit, and == itself in a second
    call."""
    from dirt_tpu_torch.ops import forward_blocks as fb
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    cases = {}
    for tag, (background, clip, colors, faces, _) in scenes.items():
        batch, height, width, channels = background.shape
        tiles_x = _cdiv(width, tw)
        num_tiles = _cdiv(height, th) * tiles_x
        table, starts, counts, block_ids, _ = fb.pack(
            clip, colors, faces, height, width, th, tw, chunk)
        geometry = (channels, height, width, tiles_x, num_tiles, th, tw)
        if not cases:
            cases[f"{tag}, every group empty"] = (
                table, starts, torch.zeros_like(counts), block_ids,
                *geometry)
        cases[tag] = (table, starts, counts, block_ids, *geometry)
    busy = {}
    for tag, args in cases.items():
        k5, again = fb.resident_sweep(*args), fb.resident_sweep(*args)
        k1, plain = fb.raster_sweep(*args), fb.resident_sweep_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k5, plain) and torch.equal(k5, k1)
                and torch.equal(again, k5)):
            fail(f"{tag}: resident_sweep differs from its plain version, "
                 f"from raster_sweep's or between two calls (max "
                 f"{_max_abs(k5, plain)})")
        counts, num_tiles = args[2], args[8]
        groups = _cdiv(num_tiles, fb.RESIDENT_TILES)
        padded = torch.zeros(counts.numel() // num_tiles,
                             groups * fb.RESIDENT_TILES,
                             dtype=torch.int32, device=counts.device)
        padded[:, :num_tiles] = counts.reshape(-1, num_tiles)
        live = (padded.reshape(-1, fb.RESIDENT_TILES) > 0).sum(-1)
        busy[tag] = (int((live > 0).sum()), live.numel(), int(live.max()),
                     int(counts.max()))
    phase("kernels", f"K5 resident_sweep, {fb.RESIDENT_TILES} tile(s) a "
          f"block; (live groups, groups, most busy tiles in a group, most "
          f"visits in a run): " + "; ".join(
              f"{tag} {v}" for tag, v in busy.items())
          + ": == its plain version and K1 bit for bit, == in two calls OK")


def check_truncated(tag, scene):
    """Truncating slot budgets on `scene`: half the slots the image with
    fewer needs, forward and gradient.  K5b and K6 against their plain
    versions; `dropped` == the slots the fused runs imply beyond the
    budget (each tile's hits, at least one); every tile without a
    surviving slot is background and every face block without one has
    zero rows."""
    from dirt_tpu_torch.ops import (forward_blocks as fb, forward_dense,
                                    grad_blocks as gb, prepass_fused)
    background, clip, colors, faces, weights = scene
    batch, height, width, channels = background.shape
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    tiles_x, num_tiles = _cdiv(width, tw), _cdiv(height, th) * _cdiv(
        width, tw)
    _, _, counts, _, _ = fb.pack(clip, colors, faces, height, width, th, tw,
                                 chunk)
    need = counts.clamp(min=1).reshape(batch, -1).sum(-1)
    budget = int(need.min()) // 2
    with slot_budget(budget):
        table, slot_tile, slot_block, slot_dma, dropped = fb.pack(
            clip, colors, faces, height, width, th, tw, chunk, slots=True)
    grad_schedule = (clip, faces, height, width, gb.TILE_H, gb.TILE_W,
                     gb.CHUNK)
    gcounts = gb.pack(*grad_schedule)[2]
    with slot_budget(int(gcounts.clamp(min=1).reshape(batch, -1).sum(-1)
                         .min()) // 2):
        gtable, slot_run, slot_item, gslot_dma, _ = gb.pack(
            *grad_schedule, slots=True)
    if not torch.equal(dropped, (need - budget).clamp(min=0).to(
            dropped.dtype)):
        fail(f"{tag}: slot budget {budget}: dropped {dropped.tolist()}, the "
             f"fused runs imply {(need - budget).tolist()}")
    args = (table, slot_tile, slot_block, slot_dma, batch, channels, height,
            width, tiles_x, num_tiles, th, tw)
    state = fb.slot_sweep(*args)
    if not torch.equal(state, fb.slot_sweep_plain(*args)):
        fail(f"{tag}: truncated slot_sweep differs from its plain version")
    swept = torch.zeros(batch * num_tiles, dtype=torch.bool,
                        device=state.device)
    swept[slot_tile.long()] = True
    init = forward_dense.init_state(channels, th * tw, device=state.device)
    cut = int((~swept).sum())
    if cut == 0 or not torch.equal(state[~swept],
                                   init.expand(cut, -1, -1)):
        fail(f"{tag}: the {cut} tiles the slot budget cut are not "
             f"background")

    pixels, aux = fb.rasterise_batch(background, clip, colors, faces)
    np_dma = _cdiv(gb.grad_dense.plane_layout("all", channels)[0], 8) * 8
    planes, _ = prepass_fused.plane_stack(pixels, weights, aux, gb.TILE_H,
                                          gb.TILE_W, np_dma)
    gargs = (gtable, planes, slot_run, slot_item, gslot_dma, channels, "all")
    rows, want = gb.slot_grad_reduce(*gargs), gb.slot_grad_reduce_plain(
        *gargs)
    rel = _max_abs(rows, want) / max(float(want.abs().max()), 1.0)
    live = torch.zeros(gtable.shape[0], dtype=torch.bool, device=rows.device)
    live[slot_run[slot_item >= 0].long()] = True
    if not rel <= ROW_TOL or bool(rows[~live].any()) or bool(live.all()):
        fail(f"{tag}: truncated slot_grad_reduce: rel {rel}, "
             f"{int((~live).sum())} cut blocks, non-zero among them: "
             f"{bool(rows[~live].any())}")
    phase("kernels", f"{tag}: slot budget {budget}: dropped "
          f"{dropped.tolist()} as the fused runs imply, K5b == plain, {cut} "
          f"cut tiles background; K6 rel {rel:.2e}, "
          f"{int((~live).sum())} cut face blocks zero OK")


@contextlib.contextmanager
def _environ(name, value):
    """Within the block, environment variable `name` is `value`."""
    saved = os.environ.get(name)
    os.environ[name] = str(value)
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def _constants(module, **values):
    """Within the block, the constants of dirt_tpu_torch.ops.`module` take
    `values`."""
    mod = _ops_module(module)
    saved = {name: getattr(mod, name) for name in values}
    for name, value in values.items():
        setattr(mod, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(mod, name, value)


def slot_budget(slots):
    """DIRT_TPU_TORCH_SLOTS_PER_IMAGE is `slots`."""
    return _environ("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", slots)


@contextlib.contextmanager
def slot_schedule():
    """The forward and the gradient take the slot schedule
    (forward_blocks.FUSED and grad_blocks.FUSED off)."""
    with _constants("forward_blocks", FUSED=False), _constants(
            "grad_blocks", FUSED=False):
        yield


def resident_table():
    """forward_blocks.RESIDENT_MB is 0 (auto: the device's opt-in shared
    memory per block)."""
    return _constants("forward_blocks", RESIDENT_MB=0.0)


def diagonal_dilation():
    """The gradient pre-pass (K2 and its plain version) also tries the
    four diagonal neighbours (backward.DIAGONAL)."""
    return _constants("backward", DIAGONAL=True)


def grad_backend(name):
    """DIRT_TPU_TORCH_GRAD_BACKEND is `name` (the gradient every autograd
    backward runs)."""
    return _environ("DIRT_TPU_TORCH_GRAD_BACKEND", name)


# Each kernel's wrapper and plain version, as (module under
# dirt_tpu_torch.ops, wrapper, plain).  The paths call every wrapper
# through its module's namespace, so `recording` can stand in for it.
WRAPPERS = {
    "face_table": ("forward_blocks", "face_table", "face_table_plain"),
    "hit_plane": ("forward_blocks", "hit_blocks", "hit_blocks_plain"),
    "build_runs": ("forward_blocks", "build_runs", "build_runs_plain"),
    "raster_sweep": ("forward_blocks", "raster_sweep", "raster_sweep_plain"),
    "slot_sweep": ("forward_blocks", "slot_sweep", "slot_sweep_plain"),
    "resident_sweep": ("forward_blocks", "resident_sweep",
                       "resident_sweep_plain"),
    "dense_sweep": ("forward_dense", "dense_sweep", "dense_sweep_plain"),
    "grad_prepass": ("prepass_fused", "plane_stack", "plane_stack_plain"),
    "grad_reduce": ("grad_blocks", "grad_reduce", "grad_reduce_plain"),
    "slot_grad_reduce": ("grad_blocks", "slot_grad_reduce",
                         "slot_grad_reduce_plain"),
    "dense_grad_reduce": ("grad_dense", "dense_grad_reduce",
                          "dense_grad_reduce_plain"),
    "pallas_raster": ("forward_pallas", "pallas_raster",
                      "pallas_raster_plain"),
    "mxu_grad": ("grad_mxu", "mxu_grad", "mxu_grad_plain"),
}
BITWISE = ("face_table", "hit_plane", "build_runs", "raster_sweep",
           "slot_sweep", "resident_sweep", "dense_sweep", "grad_prepass",
           "pallas_raster")
# The launch shape of every K3 / K6 call the paths make (check_recorded):
# {(kernel, parts, channels, chunk, pix): grad_blocks.ReduceShape}.
REDUCE_LAUNCHES = {}
# ... of every K9 call: {(parts, channels, slots): grad_dense.DenseShape};
# of every K10 call: {(columns, chunk, chunks a band): grad_mxu.MxuShape}.
DENSE_LAUNCHES = {}
MXU_LAUNCHES = {}


def _ops_module(name):
    return importlib.import_module(f"dirt_tpu_torch.ops.{name}")


def _tensors(out):
    return list(out) if isinstance(out, tuple) else [out]


@contextlib.contextmanager
def recording():
    """Within the block, each kernel wrapper also records its arguments
    and a copy of its results; yields the list of (kernel, args, kwargs,
    results).  The wrappers launch and count as they always do."""
    calls, saved = [], []
    for name, (module, wrapper, _) in WRAPPERS.items():
        mod = _ops_module(module)
        original = getattr(mod, wrapper)

        def record(*args, _name=name, _original=original, **kwargs):
            out = _original(*args, **kwargs)
            calls.append((_name, args, kwargs,
                          [t.clone() for t in _tensors(out)]))
            return out
        setattr(mod, wrapper, record)
        saved.append((mod, wrapper, original))
    try:
        yield calls
    finally:
        for mod, wrapper, original in saved:
            setattr(mod, wrapper, original)


def check_recorded(tag, path, calls, plain_s=None):
    """Holds each recorded kernel call against its plain version on the
    same arguments: K13 (as bits), K4, K12, K1, K5b, K5, K7, K2 and K8
    bitwise, K3, K6,
    K9 and K10 within ROW_TOL;
    fails if a kernel of `path` has no recorded call.  Returns {kernel:
    [shape of each call's first result]}; adds each plain version's
    seconds to plain_s[kernel] where plain_s is given."""
    from dirt_tpu_torch.ops import _cuda, grad_blocks, grad_dense, grad_mxu
    checked = {}
    for name, args, kwargs, got in calls:
        module, _, plain = WRAPPERS[name]
        plain = getattr(_ops_module(module), plain)
        named = inspect.signature(plain).bind(*args, **kwargs).arguments
        if name in ("grad_reduce", "slot_grad_reduce"):
            table, planes = named["face_table"], named["planes"]
            REDUCE_LAUNCHES[(name, named["parts"], named["channels"],
                             table.shape[1], planes.shape[2])] = (
                grad_blocks.launch_shape(table, planes, named["channels"],
                                         named["parts"]))
        elif name == "dense_grad_reduce":
            parts, channels = named["parts"], named["channels"]
            slots = named["face_ids"].shape[1]
            DENSE_LAUNCHES[(parts, channels, slots)] = grad_dense.dense_shape(
                slots, channels, parts != "position")
        elif name == "mxu_grad":
            ncols, chunk = named["values"].shape[-2], named["chunk"]
            num_chunks = named["face_ids"].shape[-1] // chunk
            MXU_LAUNCHES[(ncols, chunk, num_chunks)] = grad_mxu.mxu_shape(
                chunk, num_chunks,
                _cuda.shared_memory_optin(named["face_ids"].device))
        t0 = time.perf_counter()
        want = _tensors(plain(*args, **kwargs))
        torch.cuda.synchronize()
        if plain_s is not None:
            plain_s[name] = (plain_s.get(name, 0.0) + time.perf_counter()
                             - t0)
        for g, w in zip(got, want, strict=True):
            if name in BITWISE:
                # K13's degenerate rows hold NaN: compared as bits.
                same = (same_bits(g, w) if name == "face_table"
                        else torch.equal(g, w))
                if not same:
                    fail(f"{tag}: {name} call {tuple(g.shape)} differs "
                         f"from its plain version (max {_max_abs(g, w)})")
                continue
            rel = _max_abs(g, w) / max(float(w.abs().max()), 1.0)
            if not rel <= ROW_TOL:
                fail(f"{tag}: {name} call {tuple(g.shape)} differs from its "
                     f"plain version by {rel} > {ROW_TOL}")
        checked.setdefault(name, []).append(tuple(got[0].shape))
    missing = set(PATH_KERNELS[path]) - set(checked)
    if missing:
        fail(f"{tag}: no call of {sorted(missing)} was recorded")
    return checked


# --------------------------------------------------------------------------
# Paths
# --------------------------------------------------------------------------

def step(scene, backend=None):
    """One forward + backward of the direct path; returns (pixels,
    grads)."""
    import dirt_tpu_torch
    background, clip, colors, faces, weights = scene
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (background, clip, colors)]
    pixels = dirt_tpu_torch.rasterise_batch(leaves[0], leaves[1], leaves[2],
                                            faces, backend=backend)
    (pixels * weights).sum().backward()
    return pixels.detach(), [x.grad for x in leaves]


def deferred_step(dscene, backend=None):
    """One forward + backward of the deferred path; returns (pixels,
    [background, vertex, attribute, light] gradients)."""
    import dirt_tpu_torch
    background, clip, attributes, faces, weights, light = dscene
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (background, clip, attributes, light)]
    pixels = dirt_tpu_torch.rasterise_batch_deferred(
        leaves[0], leaves[1], leaves[2], faces, make_shader(leaves[3]),
        backend=backend)
    (pixels * weights).sum().backward()
    return pixels.detach(), [x.grad for x in leaves]


def counted(path, run):
    """Runs `run` with every launch counter reset just before and read just
    after; fails if a kernel of `path` was not launched.  Returns (run's
    result, {kernel: launches})."""
    from dirt_tpu_torch.ops import _cuda
    _cuda.reset_counts()
    out = run()
    torch.cuda.synchronize()
    launches = {name: _cuda.KERNELS[name].launches
                for name in PATH_KERNELS[path]}
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        fail(f"{path} path did not launch {idle}")
    return out, launches


def _check_grads(tag, pairs):
    for name, got, want in pairs:
        if not bool(torch.isfinite(got).all()):
            fail(f"{tag}: {name} has non-finite values")
        scale = max(float(want.abs().max()), 1.0)
        err = float((got - want).abs().max()) / scale
        if not err <= GRAD_TOL:
            fail(f"{tag}: {name} differs by {err} > {GRAD_TOL} (normalised)")


def _check_same_forward(tag, got, want):
    """Pixels and every aux field equal, `dropped` included."""
    for name, g, w in [("pixels", got[0], want[0])] + [
            (field, getattr(got[1], field), getattr(want[1], field))
            for field in got[1]._fields]:
        if not torch.equal(g, w):
            fail(f"{tag}: {name} differ from the blocks path's (max "
                 f"{_max_abs(g, w)})")


def _check_plain_gradient(tag, scene, pixels, aux, grads):
    """The step's gradients against the plain scatter gradient of the same
    forward output: grad_background equal and finite, the others within
    GRAD_TOL."""
    from dirt_tpu_torch.ops import backward
    _, clip, _, faces, weights = scene
    g_bg, g_clip, g_colors = grads
    want_bg, want_v, want_c = backward.rasterise_grad_grouped(
        clip, faces, pixels, weights, aux, implementation="xla")
    if not torch.equal(g_bg, want_bg):
        fail(f"{tag}: grad_background differs from the plain gradient")
    if not bool(torch.isfinite(g_bg).all()):
        fail(f"{tag}: grad_background has non-finite values")
    _check_grads(tag, (("grad_vertices", g_clip, want_v),
                       ("grad_vertex_colors", g_colors, want_c)))


def check_main_path(scene, backend="blocks"):
    """Drives the direct path on `backend` and checks it (phase 4a/4b/4d);
    returns the launches of its kernels."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import dispatch
    from dirt_tpu_torch.utils import oracle
    background, clip, colors, faces, _ = scene

    with recording() as calls:
        (pixels, grads), launches = counted(backend,
                                            lambda: step(scene, backend))
    phase(backend, f"launches in one step: {launches}")
    shapes = check_recorded(backend, backend, calls)
    phase(backend, f"each kernel call of the step == (K3/K9/K10 within "
          f"{ROW_TOL}) its plain version on the same inputs: {shapes}")

    px_aux, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces, backend=backend)
    if not torch.equal(px_aux, pixels):
        fail(f"{backend}: rasterise_batch_with_aux pixels differ from the "
             f"step's")
    if int(aux.dropped.max()) != 0:
        fail(f"{backend}: dropped visits: {aux.dropped.tolist()}")

    want_px, want_index = oracle.rasterise(
        background[0].cpu().numpy(), clip[0].cpu().numpy(),
        colors[0].cpu().numpy(), faces[0].cpu().numpy())
    if not np.array_equal(aux.face_index[0].cpu().numpy(), want_index):
        fail(f"{backend}: winner map of image 0 differs from the native "
             f"oracle")
    got_px = pixels[0].cpu().numpy()
    if not np.allclose(got_px, want_px, atol=1e-4, rtol=1e-5):
        fail(f"{backend}: pixels of image 0 differ from the native oracle by "
             f"up to {np.abs(got_px - want_px).max()}")

    other = "reference" if backend == "blocks" else "blocks"
    other_px, other_aux = dispatch.forward_batch(background, clip, colors,
                                                 faces, other)
    if not torch.equal(other_aux.face_index, aux.face_index):
        fail(f"{backend}: winner map differs from the {other} backend's")
    if backend == "pallas":
        # The same expressions as the blocks backend's finalize.
        _check_same_forward("pallas", (pixels, aux), (other_px, other_aux))
        other = "blocks (pixels and every aux field ==)"

    _check_plain_gradient(backend, scene, pixels, aux, grads)
    phase(backend, f"oracle winner map == and pixels within 1e-4; {other} "
          f"winner map ==; gradients vs plain within 3e-6; finite; "
          f"dropped 0")
    return launches


def check_deferred_path(dscene, backend):
    """Drives the deferred path on `backend` and checks it (phase 4c);
    returns the launches of its kernels."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import backward, dispatch
    background, clip, attributes, faces, weights, light = dscene
    tag = f"deferred {backend}"

    # The fused step and the two-call form run the kernels at the deferred
    # shapes (a 10-channel G-buffer: 19 state rows, colour cotangents of
    # 10 channels, parts "all" with a cotangent and parts "color"); each
    # call is held against its plain version on its own inputs.
    with recording() as calls:
        (_, (g_bg, g_clip, g_attrs, g_light)), launches = counted(
            backend, lambda: deferred_step(dscene, backend))
        phase(tag, f"launches in one step: {launches}")

        gbuffer, aux = dirt_tpu_torch.rasterise_batch_with_aux(
            background, clip, attributes, faces, backend=backend)
        gbuffer.requires_grad_(True)
        shaded = make_shader(light)(gbuffer)
        (grad_gbuffer,) = torch.autograd.grad(shaded, gbuffer, weights)
        shaded, gbuffer = shaded.detach(), gbuffer.detach()
        implementation = dispatch.GRAD_FOR_BACKEND[backend]
        _, want_v, _ = backward.rasterise_grad_grouped(
            clip, faces, shaded, weights, aux, parts="position",
            implementation=implementation)
        want_bg, _, want_attrs = backward.rasterise_grad_grouped(
            clip, faces, gbuffer, grad_gbuffer, aux, parts="color",
            implementation=implementation)
    shapes = check_recorded(tag, backend, calls)
    phase(tag, f"each kernel call of the fused step and the two-call form "
          f"== (K3/K9/K10 within {ROW_TOL}) its plain version on the same "
          f"inputs: {shapes}")
    _check_grads(tag, (("grad_background", g_bg, want_bg),
                       ("grad_vertices", g_clip, want_v),
                       ("grad_attributes", g_attrs, want_attrs)))
    if not bool(torch.isfinite(g_light).all()) or not bool(
            (g_light != 0).any()):
        fail(f"{tag}: light gradient {g_light.tolist()} is not finite and "
             f"non-zero")
    phase(tag, f"fused vs two-call within 3e-6; light gradient "
          f"{[round(float(g), 4) for g in g_light]}; finite")
    return launches


def mxu_step(scene):
    """step() on the blocks forward with the mxu gradient."""
    with grad_backend("mxu"):
        return step(scene, "blocks")


def check_mxu_path(scene, dscene):
    """Drives the blocks forward with DIRT_TPU_TORCH_GRAD_BACKEND=mxu and
    checks it (phase 4e); returns the launches of its kernels."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import dispatch
    background, clip, colors, faces, weights = scene

    with recording() as calls:
        (pixels, grads), launches = counted("mxu", lambda: mxu_step(scene))
    phase("mxu", f"launches in one step: {launches}")
    shapes = check_recorded("mxu", "mxu", calls)
    phase("mxu", f"each kernel call of the step == (K10 within {ROW_TOL}) "
          f"its plain version on the same inputs: {shapes}")
    _, aux = dispatch.forward_batch(background, clip, colors, faces,
                                    "blocks")
    _check_plain_gradient("mxu", scene, pixels, aux, grads)

    args = (background[0], clip[0], colors[0], faces[0], weights[0])
    got, got_debug = dirt_tpu_torch.rasterise_grad_debug(
        *args, grad_implementation="mxu")
    want, want_debug = dirt_tpu_torch.rasterise_grad_debug(
        *args, grad_implementation="xla")
    if not torch.equal(got_debug, want_debug):
        fail("mxu: rasterise_grad_debug's debug image differs from the "
             "plain gradient's")
    _check_grads("mxu debug", (
        ("grad_vertices", got.grad_vertices, want.grad_vertices),
        ("grad_vertex_colors", got.grad_vertex_colors,
         want.grad_vertex_colors)))

    # The deferred step: mxu has no fused form and takes two calls (the
    # colour call reduces the 10-channel G-buffer: 48 columns).
    with grad_backend("mxu"), recording() as calls:
        _, mxu_grads = deferred_step(dscene, "blocks")
    shapes = check_recorded("mxu deferred", "mxu", calls)
    with grad_backend("auto"):
        _, fused_grads = deferred_step(dscene, "blocks")
    _check_grads("mxu deferred", zip(
        ("grad_background", "grad_vertices", "grad_attributes",
         "light gradient"), mxu_grads, fused_grads))
    phase("mxu", f"gradients vs plain within 3e-6; debug image == the "
          f"plain gradient's; deferred two-call fallback (kernel calls "
          f"{shapes}, each == its plain version) vs the fused blocks "
          f"deferred step within 3e-6")
    return launches


def slots_step(scene):
    """step() on the slot schedule, forward and gradient."""
    with slot_schedule():
        return step(scene, "blocks")


def resident_step(scene):
    """step() with the resident-table forward on auto."""
    with resident_table():
        return step(scene, "blocks")


def check_slots_path(scene, dscene):
    """Drives the slot schedule (phase 4f) and checks it; returns the
    launches of its kernels."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _cuda
    background, clip, colors, faces, _ = scene
    with recording() as calls:
        (pixels, grads), launches = counted("slots",
                                            lambda: slots_step(scene))
    phase("slots", f"launches in one step: {launches}")
    fused = [_cuda.KERNELS[name].launches
             for name in ("raster_sweep", "grad_reduce")]
    if any(fused):
        fail(f"slots: the step launched K1/K3 {fused} times")
    shapes = check_recorded("slots", "slots", calls)
    phase("slots", f"each kernel call of the step == (K6 within {ROW_TOL}) "
          f"its plain version on the same inputs: {shapes}")
    blocks = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces, backend="blocks")
    with slot_schedule():
        got = dirt_tpu_torch.rasterise_batch_with_aux(
            background, clip, colors, faces, backend="blocks")
    _check_same_forward("slots", got, blocks)
    if not torch.equal(pixels, blocks[0]):
        fail("slots: the step's pixels differ from the blocks path's")
    _check_plain_gradient("slots", scene, pixels, blocks[1], grads)

    with slot_schedule(), recording() as calls:
        _, slot_grads = deferred_step(dscene, "blocks")
    shapes = check_recorded("slots deferred", "slots", calls)
    _, fused_grads = deferred_step(dscene, "blocks")
    _check_grads("slots deferred", zip(
        ("grad_background", "grad_vertices", "grad_attributes",
         "light gradient"), slot_grads, fused_grads))
    phase("slots", f"pixels and every aux field == the blocks path's; "
          f"gradients vs plain within 3e-6; deferred step (kernel calls "
          f"{shapes}, each == its plain version) vs the fused blocks "
          f"deferred step within 3e-6")
    return launches


def check_resident_path(scene, large_scene):
    """Drives the resident-table forward on auto (phase 4g) and checks it;
    returns the launches of its kernels."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _cuda, dispatch
    background, clip, colors, faces, _ = scene
    with recording() as calls:
        (pixels, grads), launches = counted("resident",
                                            lambda: resident_step(scene))
    phase("resident", f"launches in one step: {launches}")
    if _cuda.KERNELS["raster_sweep"].launches:
        fail("resident: the step launched K1")
    shapes = check_recorded("resident", "resident", calls)
    blocks = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces, backend="blocks")
    with resident_table():
        got = dirt_tpu_torch.rasterise_batch_with_aux(
            background, clip, colors, faces, backend="blocks")
    _check_same_forward("resident", got, blocks)
    if not torch.equal(pixels, blocks[0]):
        fail("resident: the step's pixels differ from the blocks path's")
    _check_plain_gradient("resident", scene, pixels, blocks[1], grads)

    _cuda.reset_counts()
    with resident_table():
        dispatch.forward_batch(*large_scene[:4], "blocks")
    torch.cuda.synchronize()
    large = {name: _cuda.KERNELS[name].launches
             for name in ("raster_sweep", "resident_sweep")}
    if large != {"raster_sweep": 1, "resident_sweep": 0}:
        fail(f"resident: the 8192-face forward launched {large}")
    phase("resident", f"each kernel call == its plain version: {shapes}; "
          f"pixels and every aux field == the blocks path's; gradients vs "
          f"plain within 3e-6; the 8192-face forward (table over the "
          f"{_cuda.shared_memory_optin(clip.device)}-byte opt-in shared "
          f"memory) launched {large}")
    return launches


def accum_instances():
    """K11's inputs (numpy): the repro's own sizes, and 256 tiles x 8
    chunks with random counts."""
    from dirt_tpu_torch.repro import scalar_accum as sa
    return {"repro 4 tiles x 2 chunks": sa.repro_inputs(),
            "256 tiles x 8 chunks": sa.repro_inputs(
                tiles=256, chunks=8, seed=1, random_counts=True)}


def accum_work(planes, ids, counts):
    """K11's bytes (planes, ids, counts read, rows written, once) and
    operations (a compare per live row and pixel, the sums of a match)."""
    tiles, num_ids = ids.shape[0], ids.shape[-1]
    live = (torch.arange(num_ids, device=ids.device)[None]
            < counts.reshape(tiles, 1))
    matches = int(((planes[:, 2].reshape(tiles, 1, -1)
                    == ids.reshape(tiles, -1, 1)) & live[..., None]).sum())
    pix = planes[0, 0].numel()
    return (_nbytes(planes, ids, counts) + tiles * num_ids * 4 * 4,
            int(live.sum()) * pix * OPS_ACCUM_SCAN
            + matches * OPS_ACCUM_MATCH)


def check_repro(device):
    """Runs K11 on accum_instances (phase 4h); returns (launches, {name:
    (kernel call, plain call)}, max |kernel - plain| on the larger, its
    bound's bytes and operations, its library call)."""
    from dirt_tpu_torch.repro import scalar_accum as sa
    instances = accum_instances()
    tensors = {tag: [torch.as_tensor(a, device=device) for a in arrays]
               for tag, arrays in instances.items()}
    outs, launches = counted("repro", lambda: {
        tag: sa.scalar_accum(*t) for tag, t in tensors.items()})
    for tag, got in outs.items():
        want = sa.scalar_accum_plain(*tensors[tag], sa.CHUNK)
        rel = _max_abs(got, want) / max(float(want.abs().max()), 1.0)
        ref = repro_reference(*instances[tag], sa.CHUNK)
        err = float(np.abs(got.cpu().numpy() - ref).max())
        if not (rel <= ROW_TOL and err < 1e-3
                and bool(torch.isfinite(got).all())):
            fail(f"repro {tag}: scalar_accum rel {rel} vs plain, max err "
                 f"{err} vs the numpy reference")
        phase("repro", f"{tag}: K11 scalar_accum rel {rel:.2e} vs its plain "
              f"version, max err {err:.2e} vs the numpy reference OK")
    planes, ids, counts = tensors["256 tiles x 8 chunks"]
    return (launches,
            (lambda: sa.scalar_accum(planes, ids, counts),
             lambda: sa.scalar_accum_plain(planes, ids, counts, sa.CHUNK)),
            _max_abs(outs["256 tiles x 8 chunks"],
                     sa.scalar_accum_plain(planes, ids, counts, sa.CHUNK)),
            accum_work(planes, ids, counts),
            lambda: accum_bmm(planes, ids, counts, sa.CHUNK))


def time_accum(device, card_line):
    """K11 on accum_instances: profiler device ms and CUDA-event ms (median
    of STEPS), beside its bound."""
    from dirt_tpu_torch.repro import scalar_accum as sa
    for tag, arrays in accum_instances().items():
        planes, ids, counts = (torch.as_tensor(a, device=device)
                               for a in arrays)
        run = lambda: sa.scalar_accum(planes, ids, counts)
        ms, by = bound(*accum_work(planes, ids, counts))
        phase("timing", f"K11 scalar_accum on {tag}: "
              f"{device_time(run, 'scalar_accum'):.4f} ms device, "
              f"{time_ms(run, STEPS):.4f} ms CUDA events, bound {ms:.6f} ms "
              f"({by}) on {card_line}")


# --------------------------------------------------------------------------
# Renderer models and samples
# --------------------------------------------------------------------------

def model_cases():
    """Phase 4i's renderers at MODEL_SIZE (numpy scenes, seeded): {tag:
    (model, render arguments, indices of the arguments differentiated,
    indices of those whose gradients are held against the CPU's)}: the
    deferred renderers also differentiate the object rotation, so that
    their G-buffer's backward (K2, K3) runs;
    Gouraud on the split cube (samples/simple.py's scene) and on the
    bench's 512-face cylinder split by face, deferred Phong on the cube
    (samples/deferred.py's light), textured on samples/textured.py's
    prism, stripes texture and camera."""
    from dirt_tpu_torch import lighting, models
    from dirt_tpu_torch.samples import textured
    from dirt_tpu_torch.utils import meshes
    split = lambda v, f: tuple(
        x.numpy() for x in lighting.split_vertices_by_face(v, f,
                                                           device="cpu"))
    cube_v, cube_f = split(*meshes.build_cube())
    cyl_v, cyl_f = split(*meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, 64))
    albedo = np.random.RandomState(2).uniform(
        0.2, 1.0, size=cyl_v.shape).astype(np.float32)
    light = np.array([1., -0.3, -0.5], np.float32)
    light /= np.linalg.norm(light)
    prism_v, prism_uv, prism_f = textured.icosahedron_like_prism()
    width, height = MODEL_SIZE
    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "gouraud cube": (
            models.GouraudRenderer(width, height),
            [cube_v, cube_f, np.ones_like(cube_v), f32([0., 0.5, 0.])],
            (3,), (3,)),
        "gouraud cylinder 512f": (
            models.GouraudRenderer(width, height),
            [cyl_v, cyl_f, albedo, f32([0.3, 0.5, 0.1])], (3,), (3,)),
        "phong cube": (
            models.DeferredPhongRenderer(width, height),
            [cube_v, cube_f, np.ones_like(cube_v), f32([0., 0.5, 0.]),
             light], (3, 4), (4,)),
        "textured prism": (
            models.TexturedRenderer(width, height, camera=models.Camera(
                translation=(0., -0.4, -4.0), rotation=(-0.35, 0., 0.))),
            [prism_v, prism_f, prism_uv, textured.stripes_texture(),
             f32([0.2, 0.7, 0.]), light], (3, 4, 5), (3, 5)),
    }


def model_weights(device):
    width, height = MODEL_SIZE
    return torch.as_tensor(np.random.RandomState(3).uniform(
        0.5, 1.5, size=(height, width, 3)).astype(np.float32), device=device)


def model_args(arrays, grads, device):
    """The render arguments as tensors on `device`: faces int32, the rest
    float32, those at `grads` leaves that require grad."""
    return [torch.tensor(a, device=device, requires_grad=i in grads)
            if i in grads else torch.as_tensor(
                a, device=device,
                dtype=torch.int32 if a.dtype.kind == "i" else torch.float32)
            for i, a in enumerate(arrays)]


def model_step(model, arrays, grads, weights):
    """One forward + backward of `model` on `arrays` (on weights' device);
    returns (pixels, [gradient of each argument in grads])."""
    args = model_args(arrays, grads, weights.device)
    pixels = model.render(*args)
    (pixels * weights).sum().backward()
    return pixels.detach(), [args[i].grad for i in grads]


def gouraud_reference(model, arrays, grads, weights, clip, lit):
    """The Gouraud rotation gradient on the CPU where the rasteriser sees
    the card's clip and lit values (x + (value - x).detach()), the
    derivative the CPU's: the occluder dilation's axis is an exact compare
    of Scharr magnitudes, which an ulp of the scene math can flip."""
    import dirt_tpu_torch
    args = model_args(arrays, grads, "cpu")
    background, clip_cpu, lit_cpu, faces = model.scene(*args)
    values = clip_cpu.detach(), lit_cpu.detach()
    scale = lambda x: max(float(x.abs().max()), 1.0)
    for name, got, want in zip(("clip", "lit"), (clip, lit), values):
        err = _max_abs(got.cpu(), want) / scale(want)
        if not err <= 1e-5:
            fail(f"models: the card's {name} values differ from the CPU's "
                 f"by {err}")
    clip_cpu = clip_cpu + (clip.cpu() - clip_cpu).detach()
    lit_cpu = lit_cpu + (lit.cpu() - lit_cpu).detach()
    pixels = dirt_tpu_torch.rasterise(background, clip_cpu, lit_cpu, faces,
                                      backend=model.backend)
    (pixels * weights.cpu()).sum().backward()
    return [args[i].grad for i in grads]


def check_models(device):
    """Drives each renderer of model_cases on the card, forward and
    backward (phase 4i): the launch counters show K4, K1, K2 and K3; each
    recorded kernel call == (K3: within ROW_TOL) its plain version; pixels
    within MODEL_TOL of the same model on the CPU, the compared gradients
    within MODEL_TOL of the CPU's max |grad| (Gouraud's rotation gradient
    against gouraud_reference).  Returns {tag: launches}."""
    from dirt_tpu_torch import models
    weights = model_weights(device)
    out = {}
    for tag, (model, arrays, grads, compared) in model_cases().items():
        with recording() as calls:
            (pixels, got), launches = counted("models", lambda: model_step(
                model, arrays, grads, weights))
        shapes = check_recorded(tag, "models", calls)
        if isinstance(model, models.GouraudRenderer):
            with torch.no_grad():
                want_px = model.render(*model_args(arrays, (), "cpu"))
                _, clip, lit, _ = model.scene(*model_args(arrays, (),
                                                          device))
            want = gouraud_reference(model, arrays, grads, weights, clip,
                                     lit)
        else:
            want_px, want = model_step(model, arrays, grads, weights.cpu())
        err = _max_abs(pixels.cpu(), want_px)
        if not (err <= MODEL_TOL and bool(torch.isfinite(pixels).all())):
            fail(f"{tag}: pixels differ from the CPU's by {err}")
        errors = []
        for i, g, w in zip(grads, got, want, strict=True):
            if i not in compared:
                continue
            rel = _max_abs(g.cpu(), w) / float(w.abs().max())
            if not (rel <= MODEL_TOL and bool(torch.isfinite(g).all())):
                fail(f"{tag}: the gradient of argument {i} differs from the "
                     f"CPU's by {rel} of its max")
            errors.append(f"{rel:.2e}")
        phase("models", f"{tag} {MODEL_SIZE[0]}x{MODEL_SIZE[1]}: launches "
              f"{launches}; each kernel call == (K3 within {ROW_TOL}) its "
              f"plain version {shapes}; pixels within {err:.2e} of the "
              f"CPU's, gradients (arguments {compared}) within {errors} of "
              f"their max")
        out[tag] = launches
    return out


def check_samples(device):
    """Runs the three samples' fits on the card (phase 4j): simple 40
    steps, deferred 20, textured 15, at 160x120; each must end on a finite
    loss below its first.  Returns {sample: launches}."""
    from dirt_tpu_torch.samples import deferred, simple, textured
    quiet = lambda *_: None
    # The simple fit's rotation reaches the rasteriser's backward; the
    # others' light and texture only the shader.
    fits = {
        "simple": ("models", lambda: simple.fit(device=device, log=quiet)),
        "deferred": ("forward",
                     lambda: deferred.fit(device=device, log=quiet)),
        "textured": ("forward", lambda: textured.fit(
            textured.photo_texture(log=lambda m: phase("samples", m)),
            device=device, log=quiet))}
    out = {}
    for name, (path, fit) in fits.items():
        (losses, _), launches = counted(path, fit)
        first, last = losses[0], losses[-1]
        if not (np.isfinite(last) and last < first):
            fail(f"samples: {name}'s loss went from {first} to {last}")
        phase("samples", f"{name}: {len(losses)} steps, loss {first:.6f} -> "
              f"{last:.6f}; launches {launches}")
        out[name] = launches
    return out


# --------------------------------------------------------------------------
# Sharded paths (phase 4k)
# --------------------------------------------------------------------------

# Face-sharded gradients against the unsharded blocks gradient: the ranks'
# rows sum in another order (dirt_tpu's tests/test_face_sharding.py).
SHARD_TOL = 3e-5
# The parameters of phase 4k's data-parallel fit step: offsets of the
# bench scene's first three tensors.
FIT_PARAMS = ("background", "vertices", "colors")


def _rank_profile(fn, reps):
    """torch.profiler's device ms per call of fn() over `reps` calls
    after one warm-up, profiled again, up to PROFILE_TRIES times in all,
    until every rank's profile holds device time (the ranks agree through
    an all_reduce: every rank must make the same calls, as each holds
    collectives); fails where a rank's never does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
        seen = torch.tensor([int(us > 0)], dtype=torch.int32, device="cuda")
        torch.distributed.all_reduce(seen, op=torch.distributed.ReduceOp.MIN)
        if int(seen):
            return us / 1e3 / reps
    fail(f"rank {torch.distributed.get_rank()}: no profile of "
         f"{PROFILE_TRIES} recorded device time on every rank")


def _fit_step(mesh, scene):
    """data_parallel_fit_step's run on `scene` (the global batch, the
    same on every rank): the parameters are zero offsets of its
    background, vertices and colours (so the step returns -gradient /
    size at learning rate 1), the targets its weights; each rank renders
    its shard of the offset scene (rasterise_batch_sharded)."""
    from dirt_tpu_torch.parallel import sharding
    params = sharding.replicated(mesh, {
        name: torch.zeros_like(x) for name, x in zip(FIT_PARAMS, scene)})
    faces, targets = sharding.batch_sharded(mesh, scene[3:5])

    def render_fn(p, shard):
        local = sharding.batch_sharded(
            mesh, [x + p[name] for name, x in zip(FIT_PARAMS, scene)])
        return sharding.rasterise_batch_sharded(mesh, *local, faces)
    return lambda: sharding.data_parallel_fit_step(
        mesh, render_fn, params, targets, learning_rate=1.0)


def sharded_rank(cases, arrays):
    """One rank of phase 4k: for each case of `cases` ("batch", "fit",
    "faces", "faces cylinder", "faces 2x2"; `arrays` {scene: numpy
    arrays}), the counters reset, one sharded step (the main path: a
    forward + backward, or for "fit" one data_parallel_fit_step) with
    every kernel call recorded, the counters read, each recorded call
    held against its plain version (check_recorded); then the
    face-sharded forward with aux, the step's median time and its
    profiler device time.  Returns {"cases": {case: dict}, "entered":
    the wall clock at entry, "seconds": the work's}."""
    entered = time.time()
    from dirt_tpu_torch.ops import _cuda
    from dirt_tpu_torch.parallel import face_sharding, sharding
    device = torch.device("cuda", torch.cuda.current_device())
    world = torch.distributed.get_world_size()
    tag = (f"{torch.distributed.get_backend()} x{world} rank "
           f"{torch.distributed.get_rank()}")
    out = {}
    for case in cases:
        scene = [torch.as_tensor(a, device=device)
                 for a in arrays["cylinder" if "cylinder" in case
                                 else "bench"]]
        if case == "fit":
            run = _fit_step(sharding.make_mesh(world), scene)
        elif case == "batch":
            mesh = sharding.make_mesh(world)
            scene = sharding.batch_sharded(mesh, scene)
            render = lambda leaves: sharding.rasterise_batch_sharded(
                mesh, leaves[0], leaves[1], leaves[2], scene[3])
            weights = scene[4]
        else:
            two_d = case == "faces 2x2"
            mesh = face_sharding.make_face_mesh(
                world, batch_shards=2 if two_d else None)
            batch_axis = sharding.BATCH_AXIS if two_d else None
            render = lambda leaves: face_sharding.rasterise_batch_face_sharded(
                mesh, leaves[0], leaves[1], leaves[2], scene[3],
                batch_axis=batch_axis)
            weights = (sharding.batch_sharded(mesh, scene[4]) if two_d
                       else scene[4])

        if case != "fit":
            def run():
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in scene[:3]]
                pixels = render(leaves)
                (pixels * weights).sum().backward()
                return pixels.detach(), [x.grad for x in leaves]

        _cuda.reset_counts()
        with recording() as calls:
            first = run()
        torch.cuda.synchronize()
        launches = {name: _cuda.KERNELS[name].launches
                    for name in PATH_KERNELS["blocks"]}
        check_recorded(f"{tag} {case}", "blocks", calls)
        del calls
        if case == "fit":
            result = {"params": first[0], "loss": first[1]}
        else:
            result = {"pixels": first[0], "grads": first[1]}
        result["launches"] = launches
        if case in ("faces", "faces cylinder"):
            with torch.no_grad():
                result["aux"] = face_sharding.\
                    rasterise_batch_face_sharded_with_aux(mesh, *scene[:4])
        result["ms"] = time_ms(run, STEPS)
        result["device_ms"] = _rank_profile(run, PROFILE_STEPS)
        out[case] = result
    return {"cases": out, "entered": entered,
            "seconds": time.time() - entered}


def dryrun_rank(n):
    """One rank of dryrun_multichip(n) on the card (dryrun.rank_passes),
    with every kernel call recorded and held against its plain version
    (check_recorded); returns rank_passes' record of each pass."""
    from dirt_tpu_torch.parallel import dryrun
    with recording() as calls:
        passes = dryrun.rank_passes(n, "cuda")
    check_recorded(f"dryrun rank {torch.distributed.get_rank()}", "dryrun",
                   calls)
    return passes


def _check_fit(tag, ranks, scene):
    """Each rank's data_parallel_fit_step against the unsharded step on
    the whole batch: the new parameters equal on every rank, their
    gradient (-new at learning rate 1) and the loss within GRAD_TOL
    (normalised) of the blocks backend's; returns the largest
    difference."""
    import dirt_tpu_torch
    leaves = [x.detach().clone().requires_grad_(True) for x in scene[:3]]
    rendered = dirt_tpu_torch.rasterise_batch(*leaves, scene[3],
                                              backend="blocks")
    loss = torch.sum((rendered - scene[4]) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    total = scene[4].numel()
    want = {"loss": loss.detach() / total}
    want.update({name: g / total for name, g in zip(FIT_PARAMS, grads)})
    worst = 0.0
    for r, res in enumerate(ranks):
        if r and not all(torch.equal(res["params"][k], ranks[0]["params"][k])
                         for k in FIT_PARAMS):
            fail(f"{tag} fit: rank {r}'s new parameters differ from rank 0's")
        got = {"loss": res["loss"]}
        got.update({k: -res["params"][k] for k in FIT_PARAMS})
        for name, w in want.items():
            g = got[name].to(w.device)
            err = _max_abs(g, w) / max(float(w.abs().max()), 1e-30)
            if not (err <= GRAD_TOL and bool(torch.isfinite(g).all())):
                fail(f"{tag} fit: rank {r}'s {name} differs by {err} > "
                     f"{GRAD_TOL} (normalised) from the unsharded step's")
            worst = max(worst, err)
        idle = [k for k, n in res["launches"].items() if n <= 0]
        if idle:
            fail(f"{tag} fit: rank {r} did not launch {idle}")
    return worst


def _check_sharded_case(tag, case, ranks, scene, num_faces):
    """Holds each rank's result of `case` against the unsharded blocks
    path on the same images; returns the largest normalised gradient
    difference."""
    rank_images = scene[0].shape[0]
    if case == "batch":
        rank_images //= len(ranks)
    elif case == "faces 2x2":
        rank_images //= 2
    tol = GRAD_TOL if case == "batch" else SHARD_TOL
    worst = 0.0
    for r, res in enumerate(ranks):
        idle = [k for k, n in res["launches"].items() if n <= 0]
        if idle:
            fail(f"{tag} {case}: rank {r} did not launch {idle}")
        if case == "batch":
            first = r * rank_images
        elif case == "faces 2x2":     # ranks [[0, 1], [2, 3]]
            first = r // 2 * rank_images
        else:
            first = 0
        shard = [x[first:first + rank_images] for x in scene]
        want_px, want_grads = step(shard, "blocks")
        got_px = res["pixels"].to(want_px.device)
        if not torch.equal(got_px, want_px):
            fail(f"{tag} {case}: rank {r}'s pixels differ from the "
                 f"unsharded blocks render (max {_max_abs(got_px, want_px)})")
        got = [g.to(want_px.device) for g in res["grads"]]
        if case == "faces 2x2":
            # the leaves are the global tensors: rows of other batch
            # shards get no gradient
            rows = slice(first, first + rank_images)
            if any(bool(g.index_fill(0, torch.arange(
                    rows.start, rows.stop, device=g.device), 0).any())
                    for g in got):
                fail(f"{tag} {case}: rank {r} has gradients outside its "
                     f"batch shard")
            got = [g[rows] for g in got]
        if case != "batch" and not torch.equal(got[0], want_grads[0]):
            fail(f"{tag} {case}: rank {r}'s grad_background differs")
        for name, g, w in zip(("grad_background", "grad_vertices",
                               "grad_vertex_colors"), got, want_grads):
            err = _max_abs(g, w) / max(float(w.abs().max()), 1.0)
            if not (err <= tol and bool(torch.isfinite(g).all())):
                fail(f"{tag} {case}: rank {r}'s {name} differs by {err} > "
                     f"{tol} (normalised)")
            worst = max(worst, err)
        if "aux" in res:
            import dirt_tpu_torch
            want = dirt_tpu_torch.rasterise_batch_with_aux(
                *scene[:4], backend="blocks")
            got_aux = res["aux"]
            got_aux = (got_aux[0].to(want_px.device),
                       type(want[1])(*(f.to(want_px.device)
                                       for f in got_aux[1])))
            _check_same_forward(f"{tag} {case} rank {r} with aux", got_aux,
                                want)
            ids = got_aux[1].face_index
            nloc = num_faces // len(ranks)
            if len(ranks) > 1 and not (bool((ids[ids >= 0] < nloc).any())
                                       and bool((ids >= nloc).any())):
                fail(f"{tag} {case}: the winners do not span the ranks")
    return worst


def check_sharded(scene, large_scene, card_line):
    """Drives the sharded paths (phase 4k) over launch.run_ranks, every
    rank on the card: the batch-sharded step, the data-parallel fit step
    and the face-sharded step (bench and 8,192-face cylinder) at world
    size 2 over gloo, the 2 x 2 layout at 4 over gloo, the batch-sharded,
    fit and face-sharded bench steps at 1 over NCCL (and at one rank a
    card, where there are several cards), then dryrun_multichip(2)'s
    passes.  Every kernel call of a rank's step is held against its
    plain version in the rank; each rank's pixels == the unsharded blocks
    render of its images (face-sharded: every aux field too), its
    gradients within GRAD_TOL (batch, fit) or SHARD_TOL (faces) of the
    unsharded step's, K4, K1, K2 and K3 launched on every rank.  Returns
    {run: {rank: launches}}."""
    from dirt_tpu_torch.parallel import launch
    numpy = lambda s: [x.cpu().numpy() for x in s]
    arrays = {"bench": numpy(scene), "cylinder": numpy(large_scene)}
    scenes = {"bench": scene, "cylinder": large_scene}
    runs = [("gloo", 2, ("batch", "fit", "faces", "faces cylinder")),
            ("gloo", 4, ("faces 2x2",)),
            ("nccl", 1, ("batch", "fit", "faces"))]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs.append(("nccl", cards, ("batch", "fit", "faces")))
    out = {}
    for backend, world, cases in runs:
        t0 = time.time()
        results = launch.run_ranks(world, sharded_rank, (cases, arrays),
                                   backend=backend, device="cuda")
        t1 = time.time()
        for case in cases:
            tag = f"{backend} x{world}"
            name = "cylinder" if "cylinder" in case else "bench"
            ranks = [r["cases"][case] for r in results]
            launches = {f"rank {r}": res["launches"]
                        for r, res in enumerate(ranks)}
            if case == "fit":
                worst = _check_fit(tag, ranks, scenes[name])
                phase("sharded", f"{tag} fit ({name}, {len(ranks)} ranks): "
                      f"data_parallel_fit_step's new parameters equal on "
                      f"every rank, their gradient and the loss within "
                      f"{worst:.2e} <= {GRAD_TOL} of the unsharded step's "
                      f"(normalised); kernel calls == plain; launches "
                      f"{launches}")
            else:
                worst = _check_sharded_case(
                    tag, case, ranks, scenes[name], scenes[name][3].shape[1])
                what = ("pixels and every aux field ==" if case in (
                    "faces", "faces cylinder") else "pixels ==")
                tol = GRAD_TOL if case == "batch" else SHARD_TOL
                phase("sharded", f"{tag} {case} ({name}, {len(ranks)} "
                      f"ranks): {what} the unsharded blocks render of each "
                      f"rank's images, gradients within {worst:.2e} <= "
                      f"{tol}; kernel calls == plain; launches {launches}")
            times = "; ".join(
                f"rank {r}: {res['ms']:.4f} ms/step, device "
                f"{res['device_ms']:.4f} ms/step"
                for r, res in enumerate(ranks))
            phase("timing", f"sharded {case} over {backend} at world size "
                  f"{world} ({name}): {times}; CUDA-event median of "
                  f"{STEPS} steps, profiler over {PROFILE_STEPS}; "
                  + ("every rank on cuda:0" if cards == 1 else
                     "rank r on cuda:r mod cards")
                  + (", so gloo on one card is not a scaling figure"
                     if backend == "gloo" and cards == 1 else "")
                  + f"; on {card_line}")
            out[f"{tag} {case}"] = launches
        start = max(r["entered"] for r in results) - t0
        work = max(r["seconds"] for r in results)
        phase("sharded", f"{backend} x{world}: {time.time() - t0:.1f} s: "
              f"ranks started in {start:.1f} s, worked {work:.1f} s, "
              f"joined and returned at {t1 - t0:.1f} s, checked in "
              f"{time.time() - t1:.1f} s")
    t0 = time.perf_counter()
    ranks = launch.run_ranks(2, dryrun_rank, (2,), backend="gloo",
                             device="cuda")
    for r, passes in enumerate(ranks):
        for name, record in passes.items():
            path = "dense" if name == "fit dense" else "blocks"
            idle = [k for k in PATH_KERNELS[path]
                    if record["launches"].get(k, 0) <= 0]
            if idle:
                fail(f"dryrun rank {r} {name}: did not launch {idle}")
            if record["loss"] != ranks[0][name]["loss"]:
                fail(f"dryrun {name}: rank {r}'s loss differs from rank 0's")
    phase("sharded", f"dryrun_multichip(2)'s passes (dryrun.rank_passes) "
          f"over gloo on the card: finite, kernel calls == plain, losses "
          f"and launches {ranks[0]} on rank 0, the same losses on rank 1 "
          f"({time.perf_counter() - t0:.1f} s)")
    out.update({f"dryrun {name}": {f"rank {r}": passes[name]["launches"]
                                   for r, passes in enumerate(ranks)}
                for name in ranks[0]})
    return out


# --------------------------------------------------------------------------
# Scale, camera crossing and the cylinder Jacobian (phase 4l)
# --------------------------------------------------------------------------

# sweeps/_sweep_r2.py:100-106's configurations as (tag, batch, resolution,
# cylinder segments: 8 faces a segment, projection half-width), then the
# 65,536-face mesh zoomed in, closer to a user's large mesh: image 0
# covers 29,212 of its 262,144 pixels (2,015 at 0.25).
SCALE_ROWS = (
    ("16x128^2x512f", 16, 128, 64, 0.25),
    ("16x256^2x512f", 16, 256, 64, 0.25),
    ("4x512^2x512f", 4, 512, 64, 0.25),
    ("16x256^2x2048f", 16, 256, 256, 0.25),
    ("16x256^2x8192f", 16, 256, 1024, 0.25),
    ("4x512^2x65536f", 4, 512, 8192, 0.25),
    ("4x512^2x65536f zoom", 4, 512, 8192, ZOOM_RIGHT),
)
# From this many faces a row is adjudicated by the f64 oracle and timed
# over LARGE_STEPS steps; from KERNEL_ROW_FACES each path kernel is timed
# alone beside its bound.
LARGE_MESH = 65536
LARGE_STEPS = 10
KERNEL_ROW_FACES = 8192
SCALE_KERNELS = ("hit_plane", "raster_sweep", "grad_prepass", "grad_reduce",
                 "dense_sweep", "dense_grad_reduce")
# DIRT_TPU_TORCH_TILE_FACE_CAP of dense's checks where the default cap
# (8,192 faces a tile) drops hits: <= 0 keeps every face a tile overlaps.
UNCAPPED = 0
CROSSING_DISTANCE = 0.3   # the camera inside the bench cylinder (bench: 3)
# The benchmark cell cyl65536_b32_512_inside.inside's size (batch,
# resolution, cylinder segments): a crossing scene of phase 4l b checked
# on the blocks path alone, against the oracles on image 0.
INSIDE_CELL = (32, 512, 8192)
CLIPPED_SHARE = 0.02      # rasterise_clipped may differ on < 2% of pixels
JACOBIAN_SIZE = (48, 36)  # tests/test_cylinder_jacobian.py's W, H
JACOBIAN_BG = (0.4, 0.2, 0.2)


def _host(*tensors):
    return [t.detach().cpu().numpy() for t in tensors]


def clip_test_scene(device):
    """tests/test_clipping.py's scene (numpy seed 42): face 0 crosses the
    camera plane with one vertex behind it (w < 0), face 1 is an ordinary
    visible triangle, face 2 lies wholly behind the camera and face 3
    crosses with two vertices behind; one 48 x 64 image, weights from
    seed 43."""
    rng = np.random.RandomState(42)
    v = np.array([
        [-0.6, -0.5, 0.2, 1.0], [0.7, -0.4, 0.3, 1.2], [0.1, 0.9, -0.4, -0.8],
        [-0.8, 0.1, 0.0, 1.0], [0.2, -0.8, 0.0, 1.0], [0.6, 0.6, 0.0, 1.0],
        [-0.5, -0.5, 0.1, -1.0], [0.5, -0.5, 0.1, -1.2], [0.0, 0.7, 0.1, -0.9],
        [0.9, -0.9, 0.5, 1.5], [-0.3, 0.2, -0.2, -0.6], [0.8, 0.8, -0.3, -1.1],
    ], np.float32)
    f = np.arange(12, dtype=np.int32).reshape(4, 3)
    c = rng.uniform(size=(12, 3)).astype(np.float32)
    bg = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    w = np.random.RandomState(43).uniform(size=bg.shape).astype(np.float32)
    t = lambda a: torch.as_tensor(a[None], device=device)
    return t(bg), t(v), t(c), t(f), t(w)


def behind_faces(clip, faces):
    """[B, F] bool: faces whose three vertices all have w <= 0 (GL clips
    them away whole)."""
    w = torch.gather(clip[..., 3], 1, faces.reshape(faces.shape[0], -1).long())
    return (w.reshape(faces.shape) <= 0).all(dim=-1)


def near_boundary(index):
    """[H, W] bool: pixels within one (Chebyshev) of a boundary of the
    winner map `index` [H, W] (tests/test_clipping.py:72-94)."""
    pad = np.pad(index, 1, mode="edge")
    near = np.zeros(index.shape, bool)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            near |= pad[1 + dr:1 + dr + index.shape[0],
                        1 + dc:1 + dc + index.shape[1]] != index
    return near


def clipped_disagreement(index, clipped):
    """(pixels where `index` differs from the clipping oracle's map
    `clipped`, those of them not within one pixel of its boundaries)."""
    disagree = index != clipped
    return int(disagree.sum()), int((disagree & ~near_boundary(clipped)).sum())


def start_oracles(pool, rows, crossings):
    """Submits phase 4l's native oracle calls to `pool` (ctypes releases
    the GIL, so they run beside the card's steps), the slowest first: per
    scale row image 0's rasterise, and at LARGE_MESH faces its
    visibility_f64; per crossing scene each image's rasterise and
    rasterise_clipped.  Returns {(tag, kind[, image]): future}."""
    from dirt_tpu_torch.utils import oracle
    jobs = {}
    for tag, scene in sorted(rows.items(), key=lambda kv: -kv[1][3].shape[1]):
        background, clip, colors, faces = _host(
            *(t[0] for t in scene[:4]))
        jobs[(tag, "f32")] = pool.submit(oracle.rasterise, background, clip,
                                         colors, faces)
        if faces.shape[0] >= LARGE_MESH:
            jobs[(tag, "f64")] = pool.submit(
                oracle.visibility_f64, clip, faces, *background.shape[:2])
    for tag, scene in crossings.items():
        large = scene[3].shape[1] >= LARGE_MESH
        for b in range(1 if large else scene[0].shape[0]):
            image = _host(*(t[b] for t in scene[:4]))
            jobs[(tag, "f32", b)] = pool.submit(oracle.rasterise, *image)
            jobs[(tag, "clipped", b)] = pool.submit(
                oracle.rasterise_clipped, *image)
    return jobs


def scale_timing(tag, run, reps, card_line):
    """Times one path's step on a scale row: CUDA-event ms (median of
    `reps`), the profiler's device ms, busy share and largest items, and
    the step's peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, reps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    device_ms, n_kernels, top, _ = device_profile(run, PROFILE_STEPS)
    device = ("not measured" if device_ms is None else
              f"{device_ms:.4f} ms/step, busy share {device_ms / ms:.3f}")
    phase("scale", f"{tag}: step {ms:.4f} ms (CUDA events, median of "
          f"{reps}), device {device} (torch.profiler, {PROFILE_STEPS} "
          f"steps), {n_kernels:.0f} device kernels/step, largest {top}, "
          f"peak memory {peak:.3f} GiB on {card_line}")


def scale_kernels(tag, scene, card_line):
    """Each path kernel of a large scale row timed alone (profiler device
    ms) beside its bound, with the busiest run or list it walks."""
    with _environ("DIRT_TPU_TORCH_TILE_FACE_CAP", UNCAPPED):
        calls, info = kernel_inputs(scene)
    walks = {"raster_sweep": f"runs of up to "
             f"{int(info['sweep_visits'].max())} visits",
             "grad_reduce": f"runs of up to {int(info['visits'].max())} "
             f"tiles",
             "dense_sweep": f"lists of up to "
             f"{int(info['list_faces'].max())} faces",
             "dense_grad_reduce": f"{info['window_pixels'].numel()} live "
             f"slots"}
    parts = []
    for name in SCALE_KERNELS:
        bound_ms, bound_by = bound(*info["work"][name])
        parts.append(f"{name} {device_time(calls[name][0], name):.4f} ms "
                     f"device, bound {bound_ms:.4f} ({bound_by})"
                     + (f", {walks[name]}" if name in walks else ""))
    phase("scale", f"{tag} kernels alone (dense uncapped): "
          + "; ".join(parts) + f" on {card_line}")


def checked_step(tag, scene, backend, plain_s=None):
    """One counted, recorded step of `backend` ("mxu": the blocks forward
    with the mxu gradient) on `scene`: every path kernel launched, each
    kernel call == its plain version (plain_s: check_recorded's), the
    forward's pixels == rasterise_batch_with_aux's, nothing dropped, the
    gradients finite and within GRAD_TOL of the plain gradient.  Returns
    (pixels, aux, launches)."""
    import dirt_tpu_torch
    background, clip, colors, faces, _ = scene
    run = ((lambda: mxu_step(scene)) if backend == "mxu"
           else (lambda: step(scene, backend)))
    with recording() as calls:
        (pixels, grads), launches = counted(backend, run)
    check_recorded(f"{tag} {backend}", backend, calls, plain_s)
    del calls
    px, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces,
        backend="blocks" if backend == "mxu" else backend)
    if not torch.equal(px, pixels):
        fail(f"{tag} {backend}: rasterise_batch_with_aux's pixels differ "
             f"from the step's")
    if int(aux.dropped.max()) != 0:
        fail(f"{tag} {backend}: dropped {aux.dropped.tolist()}")
    _check_plain_gradient(f"{tag} {backend}", scene, pixels, aux, grads)
    return pixels, aux, launches


def check_scale_row(tag, scene, card_line):
    """Drives one scale row on the card (phase 4l a): the blocks step and
    the dense step (checked_step each); dense's winner map == blocks' and
    its pixels within 1e-4; where dense's default cap drops hits, its
    checks run uncapped (UNCAPPED) and its default's drops and changed
    image-0 pixels are printed.  Returns image 0's blocks and dense
    (winner map, pixels) on the host, for the oracle."""
    import dirt_tpu_torch
    background, clip, colors, faces, _ = scene
    plain_s = {"blocks": {}, "dense": {}}
    pixels, aux, launches = checked_step(tag, scene, "blocks",
                                         plain_s["blocks"])
    _, default_aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces, backend="dense")
    default_dropped = default_aux.dropped.tolist()
    changed = int((default_aux.face_index[0] != aux.face_index[0]).sum())
    del default_aux
    capped = max(default_dropped) > 0
    cap = (_environ("DIRT_TPU_TORCH_TILE_FACE_CAP", UNCAPPED) if capped
           else contextlib.nullcontext())
    with cap:
        dense_pixels, daux, dense_launches = checked_step(
            tag, scene, "dense", plain_s["dense"])
        if not torch.equal(daux.face_index, aux.face_index):
            fail(f"{tag}: dense's winner map differs from blocks' at "
                 f"{int((daux.face_index != aux.face_index).sum())} pixels")
        err = _max_abs(dense_pixels, pixels)
        if not err <= 1e-4:
            fail(f"{tag}: dense's pixels differ from blocks' by {err}")
        host = dict(blocks=_host(aux.face_index[0], pixels[0]),
                    dense=_host(daux.face_index[0], dense_pixels[0]))
        del aux, daux, pixels, dense_pixels
        phase("scale", f"{tag}: launches blocks {launches}, dense "
              f"{dense_launches}; dropped at the defaults: blocks 0, dense "
              f"{default_dropped} (changing {changed} image-0 pixels); "
              f"each kernel call == (K3/K9 within {ROW_TOL}) its plain "
              f"version, the plain versions' seconds " + str(
                  {path: {k: round(v, 3) for k, v in times.items()}
                   for path, times in plain_s.items()})
              + "; dense"
              + (f" with DIRT_TPU_TORCH_TILE_FACE_CAP={UNCAPPED} (no cap)"
                 if capped else " at the defaults")
              + ": dropped 0, winner map == blocks', pixels within 1e-4; "
              "gradients vs plain within 3e-6")
        reps = LARGE_STEPS if faces.shape[1] >= LARGE_MESH else STEPS
        scale_timing(f"{tag} blocks", lambda: step(scene, "blocks"), reps,
                     card_line)
        scale_timing(f"{tag} dense" + (" uncapped" if capped else ""),
                     lambda: step(scene, "dense"), reps, card_line)
    if faces.shape[1] >= KERNEL_ROW_FACES:
        scale_kernels(tag, scene, card_line)
    return host


def check_scale_oracle(tag, host, jobs):
    """Image 0's blocks and dense winner maps == the f32 native oracle's,
    pixels within 1e-4; at LARGE_MESH faces, also the f64 adjudication
    counts of sweeps/_sweep_r2.py:44-53.  Returns the line's text."""
    want_px, want_index = jobs[(tag, "f32")].result()
    for backend, (index, pixels) in host.items():
        bad = int((index != want_index).sum())
        if bad:
            fail(f"{tag}: {backend}'s image-0 winner map differs from the "
                 f"f32 native oracle's at {bad} of "
                 f"{int((want_index >= 0).sum())} covered pixels")
        err = float(np.abs(pixels - want_px).max())
        if not err <= 1e-4:
            fail(f"{tag}: {backend}'s image-0 pixels differ from the "
                 f"oracle's by {err}")
    text = (f"{tag}: image 0's winner map == the f32 oracle's ("
            f"{int((want_index >= 0).sum())} covered pixels), pixels within "
            f"1e-4, blocks and dense")
    if (tag, "f64") in jobs:
        index64 = jobs[(tag, "f64")].result()
        text += (f"; f64 adjudication: kernel != f64 at "
                 f"{int((host['blocks'][0] != index64).sum())}, f32 oracle "
                 f"!= f64 at {int((want_index != index64).sum())} pixels")
    return text


def check_crossing(tag, scene):
    """Drives a camera-crossing scene on the card (phase 4l b): the blocks,
    dense, pallas and mxu steps (checked_step each), no face wholly
    behind the camera drawn.  Returns {backend: (winner maps [B, H, W],
    pixels)} on the host for blocks, dense and pallas."""
    _, clip, _, faces, _ = scene
    behind = behind_faces(clip, faces)
    maps, launches = {}, {}
    for backend in ("blocks", "dense", "pallas", "mxu"):
        pixels, aux, launches[backend] = checked_step(tag, scene, backend)
        drawn = torch.gather(behind, 1,
                             aux.face_index.clamp(min=0).flatten(1).long())
        if bool((drawn & (aux.face_index.flatten(1) >= 0)).any()):
            fail(f"{tag} {backend}: a face wholly behind the camera was "
                 f"drawn")
        if backend != "mxu":
            maps[backend] = _host(aux.face_index, pixels)
    phase("crossing", f"{tag}: {int(behind.sum())} faces wholly behind the "
          f"camera, none drawn; launches {launches}; each kernel call == "
          f"(K3/K9/K10 within {ROW_TOL}) its plain version; dropped 0; "
          f"gradients (blocks, dense, pallas, mxu) finite and within 3e-6 "
          f"of plain")
    return maps


def budget_shares(scene):
    """The forward and gradient schedules of `scene`'s blocks step, as
    forward_blocks.schedule builds them: {pass: (dropped [B], the fullest
    image's visits, kept and dropped, over its slot budget)}."""
    from dirt_tpu_torch.ops import forward_blocks as fb, grad_blocks as gb
    background, clip, colors, faces, _ = scene
    batch, height, width = background.shape[:3]
    tiles = _cdiv(height, fb.TILE_H) * _cdiv(width, fb.TILE_W)
    blocks = _cdiv(faces.shape[1], fb.CHUNK)
    out = {}
    for pass_, attrs, shape in ((fb.FORWARD, colors, (tiles, blocks)),
                                (gb.GRADIENT, None, (blocks, tiles))):
        _, runs, dropped, _ = fb.schedule(
            pass_, clip, faces, attrs, height, width, fb.TILE_H, fb.TILE_W,
            fb.CHUNK, False)
        visits = runs[1].reshape(batch, -1).sum(-1) + dropped
        out[pass_.name] = (dropped.tolist(), int(visits.max())
                           / fb.slots_per_image(*shape))
    return out


def check_inside(tag, scene):
    """The benchmark's inside cell on the card (phase 4l b, INSIDE_CELL):
    K13 == the plain path on both packs' tables; the blocks step's
    forward and gradient schedules drop nothing; no face wholly behind
    the camera drawn; the gradients finite.  Returns image 0's blocks
    (winner map, pixels) on the host, check_crossing's form."""
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import forward_blocks as fb
    background, clip, colors, faces, _ = scene
    height, width = background.shape[1:3]
    rows = _cdiv(faces.shape[1], fb.CHUNK) * fb.CHUNK
    check_tables({f"{tag} forward": (clip, faces, colors, height, width,
                                     rows),
                  f"{tag} gradient": (clip, faces, None, height, width,
                                      rows)})
    shares = budget_shares(scene)
    for name, (dropped, _) in shares.items():
        if max(dropped):
            fail(f"{tag}: the {name} schedule dropped {dropped}")
    _, grads = step(scene, "blocks")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail(f"{tag}: the blocks step's gradients are not finite")
    pixels, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces, backend="blocks")
    behind = behind_faces(clip, faces)
    drawn = torch.gather(behind, 1,
                         aux.face_index.clamp(min=0).flatten(1).long())
    if bool((drawn & (aux.face_index.flatten(1) >= 0)).any()):
        fail(f"{tag}: a face wholly behind the camera was drawn")
    covered = float((aux.face_index >= 0).float().mean())
    phase("crossing", f"{tag}: K13 == plain on both tables; dropped 0 in "
          f"both schedules, the fullest image at "
          + ", ".join(f"{name} {share:.4f}"
                      for name, (_, share) in shares.items())
          + f" of its slot budget; {int(behind.sum())} faces wholly behind "
          f"the camera, none drawn; {covered:.4f} of the pixels covered; "
          f"gradients finite")
    return {"blocks": _host(aux.face_index[:1], pixels[:1])}


def check_crossing_oracle(tag, maps, jobs):
    """Every image's winner maps in `maps` (blocks, dense and pallas, or
    image 0's blocks at LARGE_MESH faces) == the f32 oracle's, pixels
    within 1e-4, and against rasterise_clipped only
    within one pixel of its boundaries, on under CLIPPED_SHARE of the
    pixels.  Returns the line's text."""
    worst = 0
    for b in range(maps["blocks"][0].shape[0]):
        want_px, want_index = jobs[(tag, "f32", b)].result()
        _, clipped = jobs[(tag, "clipped", b)].result()
        for backend, (index, pixels) in maps.items():
            if not np.array_equal(index[b], want_index):
                fail(f"{tag} {backend}: image {b}'s winner map differs from "
                     f"the native oracle's at "
                     f"{int((index[b] != want_index).sum())} pixels")
            err = float(np.abs(pixels[b] - want_px).max())
            if not err <= 1e-4:
                fail(f"{tag} {backend}: image {b}'s pixels differ from the "
                     f"oracle's by {err}")
            disagree, stray = clipped_disagreement(index[b], clipped)
            if stray:
                fail(f"{tag} {backend}: image {b} differs from the clipping "
                     f"oracle at {stray} pixels away from its boundaries")
            share = disagree / index[b].size
            if not share < CLIPPED_SHARE:
                fail(f"{tag} {backend}: image {b} differs from the clipping "
                     f"oracle on {share:.4f} of its pixels")
            worst = max(worst, disagree)
    return (f"{tag}: {', '.join(maps)} winner maps == the native "
            f"oracle's on every image checked ({len(index)}), pixels within "
            f"1e-4; vs the clipping "
            f"oracle only within one pixel of its boundaries, at most "
            f"{worst} of an image's {index[0].size} pixels")


def jacobian_scene():
    """tests/test_cylinder_jacobian.py's scene on the host: the bevelled
    cylinder (10 segments) split by face, Lambert-shaded under one light:
    (vertices [V, 4], faces [F, 3], colours [V, 3]), CPU tensors."""
    from dirt_tpu_torch import lighting
    from dirt_tpu_torch.utils import meshes
    vertices, faces = meshes.make_cylinder(0.2, 0.75, 0.1, 0., 10)
    vertices = np.concatenate(
        [vertices, np.ones([len(vertices), 1], np.float32)], axis=1)
    vertices, faces = lighting.split_vertices_by_face(vertices, faces,
                                                      device="cpu")
    normals = lighting.vertex_normals_pre_split(vertices[..., :3], faces)
    colors = lighting.diffuse_directional(
        normals, torch.ones_like(normals) * torch.tensor([0.7, 0.3, 0.6]),
        light_direction=torch.tensor([0.6, -0.5, -0.6]),
        light_color=torch.tensor([1., 1., 1.])) * 0.8 + 0.2
    return vertices, faces, colors


def jacobian_render(scene, translation, rotation_xy, bgcolor, device):
    """The test's image at JACOBIAN_SIZE, [H, W, 3] on `device`: the mesh
    rotated by `rotation_xy` about z and halved, translated, projected, on
    a background of `bgcolor`.  The scene math runs on the host, as in the
    CPU test, whatever `device` rasterises: the x translation row sits at
    0.34994 of its rtol of 0.35 in both packages, and one ulp of the
    projected vertices moves it past that (a CPU measurement, PERF.md)."""
    import dirt_tpu_torch
    from dirt_tpu_torch import matrices
    vertices, faces, colors = scene
    width, height = JACOBIAN_SIZE
    c, s = torch.cos(rotation_xy), torch.sin(rotation_xy)
    zero = torch.zeros_like(c)
    view1 = torch.diag(torch.tensor([0.5, 0.5, 0.5, 1.])) @ torch.stack([
        torch.stack([c, -s, zero, zero]), torch.stack([s, c, zero, zero]),
        torch.tensor([0., 0., 1., 0.]), torch.tensor([0., 0., 0., 1.])])
    projection = matrices.perspective_projection(
        0.1, 20., 0.2, float(height) / width, device="cpu")
    projected = (vertices @ view1 @ matrices.translation(translation)
                 @ projection)
    background = torch.ones(height, width, 3) * bgcolor
    return dirt_tpu_torch.rasterise(*(x.to(device) for x in (
        background, projected, colors, faces)))


def jacobian_background_rows(scene, device):
    """Four Jacobian rows of the background colour at pixels and channels
    drawn from numpy seed 1: [(analytic, central difference)]."""
    width, height = JACOBIAN_SIZE
    translation, rotation = torch.tensor([0., 0., -0.25]), torch.tensor(0.)
    render = lambda bg: jacobian_render(scene, translation, rotation, bg,
                                        device)
    bg0 = torch.tensor(JACOBIAN_BG)
    bg = bg0.clone().requires_grad_(True)
    pixels = render(bg)
    rng = np.random.RandomState(1)
    rows = []
    for _ in range(4):
        y, x, ch = rng.randint(height), rng.randint(width), rng.randint(3)
        g, = torch.autograd.grad(pixels[y, x, ch], bg, retain_graph=True)
        eps = 1e-2
        d = torch.zeros(3)
        d[ch] = eps
        with torch.no_grad():
            fd = (render(bg0 + d) - render(bg0 - d))[y, x, ch] / (2 * eps)
        rows.append((float(g[ch]), float(fd)))
    return rows


def jacobian_translation(scene, device):
    """The translation gradient of a smooth functional (the pixels times
    a ramp in x plus a ramp in y) and its central differences: one pixel
    along x and y, 0.02 along z.  Returns (gradient [3], differences [3])
    as numpy."""
    width, height = JACOBIAN_SIZE
    ramp = (torch.linspace(0., 1., width, device=device)[None, :, None]
            + torch.linspace(0., 2., height, device=device)[:, None, None])

    def loss(translation):
        return (jacobian_render(scene, translation, torch.tensor(0.),
                                torch.tensor(JACOBIAN_BG), device)
                * ramp).sum()

    t0 = torch.tensor([0., 0., -0.25])
    leaf = t0.clone().requires_grad_(True)
    grad, = torch.autograd.grad(loss(leaf), leaf)
    fd = []
    with torch.no_grad():
        for axis, step in ((0, 2. / width), (1, 2. / height), (2, 0.04)):
            e = torch.zeros(3)
            e[axis] = step / 2
            fd.append(float(loss(t0 + e) - loss(t0 - e)) / step)
    return grad.numpy(), np.array(fd)


def rotation_descent(scene, device, steps=30, rate=8.0):
    """Gradient descent on the rotation angle from 0.2 towards a target
    rendered at 0.45 (mean squared pixel error); returns (initial error,
    final error) in radians."""
    target_angle = 0.45
    render = lambda a: jacobian_render(scene, torch.tensor([0., 0., -0.25]),
                                       a, torch.tensor(JACOBIAN_BG), device)
    with torch.no_grad():
        target = render(torch.tensor(target_angle))
    angle = torch.tensor(0.2)
    initial = abs(float(angle) - target_angle)
    for _ in range(steps):
        leaf = angle.clone().requires_grad_(True)
        grad, = torch.autograd.grad(((render(leaf) - target) ** 2).mean(),
                                    leaf)
        angle = angle - rate * grad
    return initial, abs(float(angle) - target_angle)


def check_jacobian(device):
    """tests/test_cylinder_jacobian.py's checks, rasterised on `device`
    (phase 4l c): background rows within 1e-4 of central differences,
    the x and y translation rows within rtol 0.35, z by sign, and 30
    steps of rotation descent ending under 0.4 x the initial error."""
    scene = jacobian_scene()
    rows = jacobian_background_rows(scene, device)
    for g, fd in rows:
        if not abs(g - fd) <= 1e-4:
            fail(f"jacobian: a background row {g} differs from its central "
                 f"difference {fd}")
    grad, fd = jacobian_translation(scene, device)
    for axis in (0, 1):
        if not (abs(fd[axis]) > 1e-2
                and abs(grad[axis] - fd[axis]) <= 0.35 * abs(fd[axis])):
            fail(f"jacobian: translation row {axis}: {grad[axis]} vs "
                 f"central difference {fd[axis]}")
    if not (np.sign(grad[2]) == np.sign(fd[2]) and abs(grad[2]) > 1e-3):
        fail(f"jacobian: translation z {grad[2]} vs {fd[2]} by sign")
    initial, final = rotation_descent(scene, device)
    if not final < 0.4 * initial:
        fail(f"jacobian: rotation descent ended {final} from the target "
             f"(from {initial})")
    phase("jacobian", f"{JACOBIAN_SIZE[0]}x{JACOBIAN_SIZE[1]} cylinder: "
          f"background rows (analytic, difference) "
          f"{[(round(g, 6), round(d, 6)) for g, d in rows]} within 1e-4; "
          f"translation {grad.tolist()} vs differences {fd.tolist()} (x, y "
          f"within rtol 0.35: {abs(grad[0] - fd[0]) / abs(fd[0]):.5f}, "
          f"{abs(grad[1] - fd[1]) / abs(fd[1]):.5f}; z by sign); rotation "
          f"descent {initial:.4f} -> {final:.4f} rad in 30 steps")


def scale_scenes(device, rows=SCALE_ROWS, crossing_size=(16, 256)):
    """Phase 4l's scenes on `device`: ({tag: scale row}, {tag: crossing
    scene}), the scale rows bench_scene's, the crossing scenes
    tests/test_clipping.py's and the bench cylinder at `crossing_size`
    (batch, resolution) with the camera inside it."""
    scenes = {tag: bench_scene(batch, res, segments, device, right=right)
              for tag, batch, res, segments, right in rows}
    batch, res = crossing_size
    cell_batch, cell_res, cell_segments = INSIDE_CELL
    crossings = {
        "test_clipping 1x48x64": clip_test_scene(device),
        f"cylinder inside {batch}x{res}^2x512f": bench_scene(
            batch, res, 64, device, distance=CROSSING_DISTANCE),
        f"cylinder inside {cell_batch}x{cell_res}^2x"
        f"{8 * cell_segments}f": bench_scene(
            cell_batch, cell_res, cell_segments, device,
            distance=CROSSING_DISTANCE)}
    return scenes, crossings


def check_scale(scenes, crossings, jobs, device, card_line):
    """Phase 4l: the scale rows, the camera-crossing scenes and the
    cylinder Jacobian on the card, then the native oracle's results
    (`jobs`, start_oracles' futures, running since they were started)."""
    t0 = time.perf_counter()
    hosts, seconds = {}, {}
    for tag in list(scenes):
        t1 = time.perf_counter()
        hosts[tag] = check_scale_row(tag, scenes.pop(tag), card_line)
        torch.cuda.empty_cache()
        seconds[tag] = time.perf_counter() - t1
    t1 = time.perf_counter()
    maps = {tag: (check_inside if scene[3].shape[1] >= LARGE_MESH
                  else check_crossing)(tag, scene)
            for tag, scene in crossings.items()}
    seconds["crossing"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    check_jacobian(device)
    seconds["jacobian"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    lines = [check_scale_oracle(tag, host, jobs)
             for tag, host in hosts.items()]
    lines += [check_crossing_oracle(tag, tag_maps, jobs)
              for tag, tag_maps in maps.items()]
    seconds["waiting for the oracle"] = time.perf_counter() - t1
    for line in lines:
        phase("oracle", line)
    phase("scale", f"phase 4l: {time.perf_counter() - t0:.1f} s; seconds "
          + str({k: round(v, 1) for k, v in seconds.items()}))


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def time_ms(fn, reps):
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)




# Each kernel's CUDA kernel by the name the profiler shows (a substring
# of its key: the instantiations carry template arguments), and the
# reductions' among them.
DEVICE_KERNELS = {
    "face_table": "face_table_kernel", "hit_plane": "hit_block_kernel",
    "raster_sweep": "raster_sweep_kernel",
    "build_runs": "build_runs_kernel",
    "slot_sweep": "slot_sweep_kernel",
    "resident_sweep": "resident_sweep_kernel",
    "dense_sweep": "dense_sweep_kernel",
    "grad_prepass": "grad_prepass_kernel",
    "grad_reduce": "grad_reduce_kernel",
    "slot_grad_reduce": "slot_grad_kernel",
    "dense_grad_reduce": "dense_grad_kernel",
    "pallas_raster": "pallas_raster_kernel", "mxu_grad": "mxu_grad_kernel",
    "scalar_accum": "scalar_accum_kernel",
}
REDUCTION_KERNELS = {
    "K3/K6": (DEVICE_KERNELS["grad_reduce"],
              DEVICE_KERNELS["slot_grad_reduce"]),
    "K9": (DEVICE_KERNELS["dense_grad_reduce"],),
    "K10": (DEVICE_KERNELS["mxu_grad"],)}


def profiled(fn, reps, cpu, seen):
    """torch.profiler's key_averages() of `reps` calls of fn() after one
    warm-up (device activity, and host activity if `cpu`), profiled again,
    up to PROFILE_TRIES times in all, while seen(averages) is false: now
    and then a profile records no device event at all."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        if seen(averages):
            break
    return averages


def device_profile(fn, reps):
    """torch.profiler's view of fn(), per call over `reps` calls after one
    warm-up: (device ms, device kernels, {largest device items: ms},
    {reduction (REDUCTION_KERNELS): its device ms}); the device ms is None
    where the profiler records no device time."""
    on_device = lambda e: (str(e.device_type).endswith("CUDA")
                           and e.self_device_time_total > 0)
    device = [e for e in profiled(fn, reps, True,
                                  lambda av: any(map(on_device, av)))
              if on_device(e)]
    if not device:
        return None, 0, {}, {}
    items = {}
    reductions = dict.fromkeys(REDUCTION_KERNELS, 0.0)
    for e in device:
        ms = e.self_device_time_total / 1e3 / reps
        items[e.key[:48]] = items.get(e.key[:48], 0.0) + ms
        for label, names in REDUCTION_KERNELS.items():
            if any(name in e.key for name in names):
                reductions[label] += ms
    top = dict(sorted(items.items(), key=lambda kv: -kv[1])[:4])
    return (sum(items.values()), sum(e.count for e in device) / reps,
            {k: round(v, 4) for k, v in top.items()}, reductions)


def kernel_device_ms(fn, name, reps):
    """torch.profiler's device ms of the CUDA kernel `name` per call of
    fn(), over `reps` calls after one warm-up; None where the profiler
    records no device time of it."""
    kernel_us = lambda averages: sum(e.self_device_time_total
                                     for e in averages if name in e.key)
    us = kernel_us(profiled(fn, reps, False, kernel_us))
    return us / 1e3 / reps if us > 0 else None


def device_time(fn, name):
    """kernel_device_ms of kernel `name` (DEVICE_KERNELS) per call of
    fn(), over PROFILE_STEPS calls; fails where the profiler sees none."""
    ms = kernel_device_ms(fn, DEVICE_KERNELS[name], PROFILE_STEPS)
    if ms is None:
        fail(f"the profiler saw no device time of {name}")
    return ms


def time_sweeps(scenes, card_line):
    """The forward sweeps' and K4's times on each of `scenes` ({tag:
    (scene, kernels)}): device ms on the profiler and CUDA-event ms
    (median of STEPS) of each kernel named ("hit_plane dilate 1": K4 on
    the gradient pack's table), beside the scene's busy runs (K1's
    blocks) and busy lists (K7's and K8's)."""
    from dirt_tpu_torch.ops import (forward_blocks as fb, forward_dense,
                                    forward_pallas)
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    for tag, ((background, clip, colors, faces, _), names) in scenes.items():
        batch, height, width, channels = background.shape
        tiles_x = _cdiv(width, tw)
        num_tiles = _cdiv(height, th) * tiles_x
        geometry = (channels, height, width, tiles_x, num_tiles, th, tw)
        table, starts, counts, block_ids, _ = fb.pack(
            clip, colors, faces, height, width, th, tw, chunk)
        csr = (table, starts, counts, block_ids, *geometry)
        slots = fb.pack(clip, colors, faces, height, width, th, tw,
                        chunk, slots=True)[:4]
        dth, dtw = forward_dense.tile_shape(height, width)
        dtiles_x = _cdiv(width, dtw)
        dnum_tiles = _cdiv(height, dth) * dtiles_x
        dtable, face_ids, dcounts, _ = forward_dense.pack(
            clip, colors, faces, height, width, dth, dtw,
            forward_dense.CHUNK)
        lists = (dtable, face_ids, dcounts)
        dense = (channels, height, width, dtiles_x, dnum_tiles, dth, dtw,
                 forward_dense.CHUNK)
        pallas = (background, dtiles_x, dnum_tiles, dth, dtw,
                  forward_dense.CHUNK)
        hits = hit_tables((background, clip, colors, faces, None))
        runs = {"hit_plane": lambda: fb.hit_blocks(*hits[0]),
                "hit_plane dilate 1": lambda: fb.hit_blocks(*hits[1]),
                "raster_sweep": lambda: fb.raster_sweep(*csr),
                "slot_sweep": lambda: fb.slot_sweep(*slots, batch,
                                                    *geometry),
                "resident_sweep": lambda: fb.resident_sweep(*csr),
                "dense_sweep": lambda: forward_dense.dense_sweep(*lists,
                                                                 *dense),
                "pallas_raster": lambda: forward_pallas.pallas_raster(
                    *lists, *pallas)}
        times = [f"{name} {device_time(runs[name], name.split()[0]):.4f} "
                 f"ms device, {time_ms(runs[name], STEPS):.4f} ms CUDA events"
                 for name in names]
        for name, args in (("hit_plane", hits[0]),
                           ("hit_plane dilate 1", hits[1])):
            if name in names:
                ms = bound(*hit_work(*args))[0]
                times.append(f"{name} bound {ms:.6f} ms")
        busy = counts[counts > 0].float()
        listed = dcounts[dcounts > 0].float()
        phase("timing", f"sweeps on {tag} ({int(busy.numel())} busy runs "
              f"of {counts.numel()}, visits per busy run mean "
              f"{float(busy.mean()):.2f}, max {int(busy.max())}; "
              f"{int(listed.numel())} busy lists of {dcounts.numel()}, "
              f"faces per busy list mean {float(listed.mean()):.2f}, max "
              f"{int(listed.max())}): " + "; ".join(times)
              + f" on {card_line}")


def sweep_scenes(scene, zoom_scene, large_scene, scene_1536):
    """time_sweeps' scenes and the kernels timed on each: K4 at dilate 0
    (the forward pack's table) and 1 (the gradient pack's) on all four;
    all five sweeps on the bench and zoom scenes, all but K5 on the large
    one (its table exceeds a block's shared memory), K1 and K5 on the
    1,536-face one."""
    hits = ("hit_plane", "hit_plane dilate 1")
    every = hits + ("raster_sweep", "slot_sweep", "resident_sweep",
                    "dense_sweep", "pallas_raster")
    return {"bench 16x256^2x512f": (scene, every),
            "zoom 16x256^2x512f": (zoom_scene, every),
            "large 1x256^2x8192f": (large_scene, hits + (
                "raster_sweep", "slot_sweep", "dense_sweep",
                "pallas_raster")),
            "16x256^2x1536f": (scene_1536, hits + ("raster_sweep",
                                                   "resident_sweep"))}


def sweeps_of(tree):
    """`--sweeps-of TREE`: time_sweeps, time_k1_cells (unchecked) and
    time_accum alone, on the dirt_tpu_torch package of checkout TREE
    (another commit's: two commits compared on one card by the same timing
    code)."""
    sys.path.insert(0, os.path.abspath(tree))
    import dirt_tpu_torch
    if not os.path.abspath(dirt_tpu_torch.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        fail(f"dirt_tpu_torch was not imported from {tree}")
    device = torch.device("cuda", 0)
    card_line = card()
    phase("timing", f"the sweeps and K11 of {dirt_tpu_torch.__file__}")
    time_sweeps(sweep_scenes(
        bench_scene(16, 256, 64, device),
        bench_scene(16, 256, 64, device, right=ZOOM_RIGHT),
        bench_scene(1, 256, 1024, device),
        bench_scene(16, 256, 192, device)), card_line)
    time_k1_cells(device, card_line, check=False)
    time_accum(device, card_line)


def bound(nbytes, ops, peak_ops_per_ms=PEAK_OPS_PER_MS):
    """The least time (ms) the card could take, and what bounds it: the
    bytes over the memory rate, or the operations over `peak_ops_per_ms`
    (float32 outside the tensor cores unless the work runs on them)."""
    by_bytes = nbytes / PEAK_BYTES_PER_MS
    by_ops = ops / peak_ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def card():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    # 1. Device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if sys.argv[1:2] == ["--sweeps-of"] and len(sys.argv) == 3:
        sweeps_of(sys.argv[2])
        return
    card_line = card()
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_line}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 matmuls in f32

    # 2. Build
    from dirt_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.load()
    phase("build", f"{len(_cuda.SOURCES)} sources built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({_cuda.library_path().name})")

    # Phase 4l's native oracle calls (~3 min at 65,536 faces on the
    # card's host) run in threads from here on.
    scale = scale_scenes(device)
    oracle_pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)
    oracle_jobs = start_oracles(oracle_pool, *scale)

    # 3. Kernels vs plain
    scene = bench_scene(16, 256, 64, device)
    errors, calls, info = compare_kernels("bench 16x256^2x512f", scene)
    check_reduce_walk("bench 16x256^2x512f", calls, info)
    check_sweep_walk("bench 16x256^2x512f", info)
    scene_100 = bench_scene(4, 100, 64, device)
    compare_kernels("100x100", scene_100)
    crossing = crossing_scene(device)
    compare_kernels("camera-crossing", crossing)
    check_truncated("camera-crossing", crossing)
    large_scene = bench_scene(1, 256, 1024, device)
    compare_kernels("1x256^2x8192f", large_scene)
    check_list_walk("1x256^2x8192f", large_scene)
    zoom_scene = bench_scene(16, 256, 64, device, right=ZOOM_RIGHT)
    scene_1536 = bench_scene(16, 256, 192, device)
    check_resident_walk({"bench 16x256^2x512f": scene,
                         "zoom 16x256^2x512f": zoom_scene,
                         "16x256^2x1536f": scene_1536})
    check_hit_plane({"bench 16x256^2x512f": scene,
                     "zoom 16x256^2x512f": zoom_scene,
                     "1x256^2x8192f": large_scene,
                     "16x256^2x1536f": scene_1536,
                     "camera-crossing": crossing}, scene_100)

    # 4. Paths; each kernel's launches are those of the first path that
    # runs it (K1-K4 blocks, K7/K9 dense, K8 pallas, K10 mxu, K5b/K6
    # slots, K5 resident, K11 repro).
    launches = {}
    dscene = deferred_scene(scene)
    path_launches = [check_main_path(scene, backend)
                     for backend in ("blocks", "dense")]
    deferred_launches = {backend: check_deferred_path(dscene, backend)
                         for backend in ("blocks", "dense")}
    path_launches += [check_main_path(scene, "pallas"),
                      check_mxu_path(scene, dscene),
                      check_slots_path(scene, dscene),
                      check_resident_path(scene, large_scene)]
    repro_launches, calls["scalar_accum"], errors["scalar_accum"], \
        info["work"]["scalar_accum"], info["libraries"]["scalar_accum"] = \
        check_repro(device)
    path_launches.append(repro_launches)
    model_launches = check_models(device)
    sample_launches = check_samples(device)
    sharded_launches = check_sharded(scene, large_scene, card_line)
    check_scale(*scale, oracle_jobs, device, card_line)
    oracle_pool.shutdown()
    for counts in path_launches:
        for name, n in counts.items():
            launches.setdefault(name, n)
    visits = info["visits"].float()
    phase("kernels", f"K3/K6 at the bench configuration: visits per run "
          f"mean {float(visits.mean()):.2f}, max {int(visits.max())} over "
          f"{visits.numel()} runs; launch shapes (kernel, parts, channels, "
          f"chunk, pix): (lanes, ring depth, colour group, shared bytes) "
          + "; ".join(f"{key}: ({s.lanes}, {s.depth}, {s.group}, {s.smem})"
                      for key, s in REDUCE_LAUNCHES.items()))
    from dirt_tpu_torch.ops import forward_blocks, grad_dense, grad_mxu
    runs = info["sweep_visits"]
    busy = runs[runs > 0].float()
    optin = _cuda.shared_memory_optin(device)
    pix = forward_blocks.TILE_H * forward_blocks.TILE_W
    table = info["sweep_args"][0]
    faces = table.shape[0] * table.shape[1] // scene[0].shape[0]
    phase("kernels", f"K1/K5b at the bench configuration: {busy.numel()} "
          f"busy runs of {runs.numel()}, visits per busy run mean "
          f"{float(busy.mean()):.2f}, max {int(busy.max())}; launch shape "
          f"{forward_blocks.sweep_shape(pix, forward_blocks.CHUNK, optin)}; "
          f"K8's {forward_blocks.sweep_shape(pix, 1, optin)}; K5's "
          f"{forward_blocks.resident_shape(pix, faces, optin)}, "
          f"{forward_blocks.RESIDENT_TILES} tile(s) a block")
    window = info["window_pixels"].float()
    phase("kernels", f"K9 at the bench configuration: window pixels per "
          f"live slot mean {float(window.mean()):.2f}, max "
          f"{int(window.max())} of a tile's "
          f"{grad_dense.TILE_H * grad_dense.TILE_W}, over {window.numel()} "
          f"live slots; launch shapes (parts, channels, slots): (warps, "
          f"slots a warp, colour group) " + "; ".join(
              f"{key}: {tuple(s)}" for key, s in DENSE_LAUNCHES.items()))
    phase("kernels", f"K10 at the bench configuration: {info['live_items']} "
          f"live chunks in {info['live_bands']} live bands; clusters of "
          f"{grad_mxu.SPLIT} blocks a band, {grad_mxu.DEPTH} ring stages; "
          f"launch shapes (columns, chunk, chunks a band): (chunks a block, "
          f"shared bytes) " + "; ".join(
              f"{key}: {tuple(s)}" for key, s in MXU_LAUNCHES.items()))

    # 5. Timing
    paths = {
        "blocks direct": lambda: step(scene, "blocks"),
        "dense direct": lambda: step(scene, "dense"),
        "deferred blocks": lambda: deferred_step(dscene, "blocks"),
        "deferred dense": lambda: deferred_step(dscene, "dense"),
        "pallas direct": lambda: step(scene, "pallas"),
        "mxu direct": lambda: mxu_step(scene),
        "slots direct": lambda: slots_step(scene),
        "resident direct": lambda: resident_step(scene),
    }
    sizes = dict.fromkeys(paths, "16x256^2, 512 faces")
    weights = model_weights(device)
    for tag, (model, arrays, grads, _) in model_cases().items():
        name = f"model {tag}"
        paths[name] = (lambda model=model, arrays=arrays, grads=grads:
                       model_step(model, arrays, grads, weights))
        sizes[name] = f"{MODEL_SIZE[0]}x{MODEL_SIZE[1]}"
    steps = {name: time_ms(run, STEPS) for name, run in paths.items()}
    for name, run in paths.items():
        device_ms, n_kernels, top, reductions = device_profile(
            run, PROFILE_STEPS)
        per_step, busy = "not measured", "not measured"
        if device_ms is not None:
            per_step = f"{device_ms:.4f} ms/step"
            busy = f"{device_ms / steps[name]:.3f}"
        reduced = ", ".join(f"{label} {ms:.4f}"
                            for label, ms in reductions.items())
        phase("profile", f"{name}: device {per_step} (torch.profiler, "
              f"{PROFILE_STEPS} steps), busy share {busy} of the "
              f"{steps[name]:.4f} ms step, "
              f"{n_kernels:.0f} device kernels/step, largest {top}, "
              f"reductions ({reduced}) ms/step on {card_line}")
    kernels = []
    for name, (kernel, plain) in calls.items():
        k = _cuda.KERNELS[name]
        bound_ms, bound_by = bound(*info["work"][name])
        library = info["libraries"].get(name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"dirt_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": time_ms(kernel, STEPS),
            "device_ms": device_time(kernel, name),
            "plain_ms": time_ms(plain, 5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None else time_ms(library,
                                                               STEPS)})
        all_planes = info["all_planes"].get(name)
        all_planes = ("" if all_planes is None else
                      f" (with every plane of the image: "
                      f"{bound(*all_planes)[0]:.4f} ms)")
        phase("timing", f"{name}: {kernels[-1]['ms']:.4f} ms (device "
              f"{kernels[-1]['device_ms']:.4f}), plain "
              f"{kernels[-1]['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}){all_planes}, library "
              f"{kernels[-1]['library_ms']} ms, {launches[name]} launches "
              f"on {card_line}")
    time_sweeps(sweep_scenes(scene, zoom_scene, large_scene, scene_1536),
                card_line)
    time_hit_cells(device, card_line)
    time_k1_cells(device, card_line)
    check_build_runs(device, card_line)
    check_face_table(device, card_line)
    time_accum(device, card_line)
    for name, ms in steps.items():
        phase("timing", f"{name} step fwd+bwd {sizes[name]}: median "
              f"{ms:.4f} ms/step over {STEPS} steps on {card_line}")
    phase("timing", f"deferred launches per step: {deferred_launches}")
    phase("timing", f"model launches per step: {model_launches}; sample "
          f"fits' launches: {sample_launches}")
    phase("timing", f"sharded launches per step: {sharded_launches}")

    # 6. Result
    missing = sorted(set(_cuda.KERNELS) - {k["name"] for k in kernels})
    if missing:
        fail(f"no measurements of {missing}")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
