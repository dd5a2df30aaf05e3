#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dirt_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the port's main path -- rasterise_batch forward and its analytic
backward on the bench scene (16 x 256^2 x 3 channels, the 512-face Gouraud
cylinder, loss sum(pixels * weights)) -- and checks it phase by phase,
printing one line per phase and exiting non-zero at the first failure:

  1. device: torch and CUDA versions, the card's name and power limit;
     no CUDA device is a failure (nothing runs on the CPU);
  2. build: the four CUDA kernels, compiled from dirt_tpu_torch/csrc/;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes and on a 100x100 image, a camera-crossing scene and a
     1 x 256^2 x 8192-face cylinder: hit plane, sweep state and plane
     stack bitwise, gradient rows within max |d| / max(max |a|, 1)
     <= 1e-5 (the summation order differs);
  4. main path: the step itself with every launch counter reset before
     and read after; image 0 against the native C++ oracle; the forward's
     winner map against the reference backend on the card; gradients
     against the plain scatter gradient from the same forward output;
     finite gradients; no dropped visits; every kernel launched;
  5. timing: the median forward+backward step over 25 steps and each
     kernel against its plain version, with CUDA events;
  6. the kernels' JSON line, the card's name and power limit, and last the
     result line {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

GRAD_TOL = 3e-6      # normalised, as dirt_tpu's tests/test_grad_kernels.py
ROW_TOL = 1e-5       # K3 rows: max |kernel - plain| / max(max |plain|, 1)
STEPS = 25


def fail(message):
    print(f"chip_smoke: FAIL: {message}", flush=True)
    sys.exit(1)


def phase(name, message):
    print(f"[{name}] {message}", flush=True)


# --------------------------------------------------------------------------
# Scenes (numpy from a seed, then tensors on the device)
# --------------------------------------------------------------------------

def bench_scene(batch, resolution, segments, device):
    """The bench.py scene (bench.py:111-137), built with the port's
    matrices from numpy seed 0."""
    from dirt_tpu_torch import matrices
    from dirt_tpu_torch.utils import meshes
    rng = np.random.RandomState(0)
    vertices, faces = meshes.make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    homogeneous = np.concatenate(
        [vertices, np.ones((vertices.shape[0], 1), np.float32)], axis=1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    view = matrices.compose(matrices.translation(t([0., 0., -3.0])),
                            matrices.rodrigues(t([-0.4, 0., 0.])))
    projection = matrices.perspective_projection(
        near=0.1, far=20., right=0.25, aspect=1.).to(device)
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


# --------------------------------------------------------------------------
# Kernel vs plain
# --------------------------------------------------------------------------

def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_inputs(scene):
    """Runs the main path's stages on `scene` and returns, per kernel, a
    pair (kernel call, plain call) of zero-argument functions on the same
    inputs."""
    from dirt_tpu_torch.ops import (forward_blocks as fb, forward_dense,
                                    grad_blocks as gb, grad_dense,
                                    prepass_fused)
    background, clip, colors, faces, weights = scene
    batch, height, width, channels = background.shape
    th, tw, chunk = fb.TILE_H, fb.TILE_W, fb.CHUNK
    tiles_y, tiles_x = -(-height // th), -(-width // tw)
    table, starts, counts, block_ids, _ = fb.pack(
        clip, colors, faces, height, width, th, tw, chunk)
    # The sorted face table as the hit test sees it: [B, NB*chunk, D].
    face_data = table.reshape(batch, -1, table.shape[-1])
    hit_args = (face_data, fb._BBOX, tiles_y, tiles_x, th, tw, 0, height,
                width, 0)
    sweep_args = (table, starts, counts, block_ids, channels, height, width,
                  tiles_x, tiles_y * tiles_x, th, tw)

    pixels, aux = fb.rasterise_batch(background, clip, colors, faces)
    gh, gw, gchunk = gb.TILE_H, gb.TILE_W, gb.CHUNK
    n_planes = grad_dense.plane_layout("all", channels)[0]
    np_dma = -(-n_planes // 8) * 8
    prepass_args = (pixels, weights, aux, gh, gw, np_dma)
    planes, _ = prepass_fused.plane_stack(*prepass_args)
    gtable, gstarts, gcounts, tile_ids, _ = gb.pack(
        clip, faces, height, width, gh, gw, gchunk)
    reduce_args = (gtable, planes, gstarts, gcounts, tile_ids, channels,
                   "all")
    return {
        "hit_plane": (lambda: fb.hit_plane(*hit_args),
                      lambda: fb.hit_plane_plain(*hit_args)),
        "raster_sweep": (lambda: fb.raster_sweep(*sweep_args),
                         lambda: fb.raster_sweep_plain(*sweep_args)),
        "grad_prepass": (lambda: prepass_fused.plane_stack(*prepass_args),
                         lambda: prepass_fused.plane_stack_plain(
                             *prepass_args)),
        "grad_reduce": (lambda: gb.grad_reduce(*reduce_args),
                        lambda: gb.grad_reduce_plain(*reduce_args)),
    }, dict(background=background, channels=channels, height=height,
            width=width, tiles_y=tiles_y, tiles_x=tiles_x, tile_h=th,
            tile_w=tw, finalize=forward_dense.finalize)


def compare_kernels(tag, scene):
    """Holds each kernel against its plain version on `scene`; returns
    ({name: max |kernel - plain|}, the calls of kernel_inputs)."""
    calls, info = kernel_inputs(scene)
    errors = {}

    keep_k, keep_p = (f() for f in calls["hit_plane"])
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        fail(f"{tag}: hit_plane differs from its plain version in "
             f"{int((keep_k != keep_p).sum())} of {keep_k.numel()} entries")
    errors["hit_plane"] = _max_abs(keep_k, keep_p)

    state_k, state_p = (f() for f in calls["raster_sweep"])
    torch.cuda.synchronize()
    channels = info["channels"]
    for name, rows in (("winner map", slice(channels + 8, channels + 9)),
                       ("depth", slice(channels + 7, channels + 8)),
                       ("vertex ids", slice(channels + 4, channels + 7)),
                       ("state", slice(None))):
        if not torch.equal(state_k[:, rows], state_p[:, rows]):
            fail(f"{tag}: raster_sweep {name} differs from its plain version")
    batch = info["background"].shape[0]
    finals = []
    for state in (state_k, state_p):
        finals.append(info["finalize"](
            state.reshape(batch, info["tiles_y"] * info["tiles_x"],
                          channels + 9, -1),
            info["background"], info["height"], info["width"],
            info["tiles_y"], info["tiles_x"], tile_h=info["tile_h"],
            tile_w=info["tile_w"])[0])
    if not torch.equal(*finals):
        fail(f"{tag}: raster_sweep pixels differ after finalize")
    errors["raster_sweep"] = _max_abs(state_k, state_p)

    (planes_k, dil_k), (planes_p, dil_p) = (f() for f in calls["grad_prepass"])
    torch.cuda.synchronize()
    if not torch.equal(planes_k, planes_p):
        fail(f"{tag}: grad_prepass planes differ from the plain version "
             f"(max {_max_abs(planes_k, planes_p)})")
    if not torch.equal(dil_k, dil_p):
        fail(f"{tag}: grad_prepass dilation mask differs")
    errors["grad_prepass"] = _max_abs(planes_k, planes_p)

    rows_k, rows_p = (f() for f in calls["grad_reduce"])
    torch.cuda.synchronize()
    rel = _max_abs(rows_k, rows_p) / max(float(rows_p.abs().max()), 1.0)
    if not rel <= ROW_TOL:
        fail(f"{tag}: grad_reduce rows differ by {rel} > {ROW_TOL}")
    errors["grad_reduce"] = _max_abs(rows_k, rows_p)
    phase("kernels", f"{tag}: K4 hit_plane ==, K1 raster_sweep == (state, "
          f"pixels), K2 grad_prepass ==, K3 grad_reduce rel {rel:.2e} OK")
    return errors, calls


# --------------------------------------------------------------------------
# Main path
# --------------------------------------------------------------------------

def step(scene):
    """One forward + backward of the main path; returns (pixels, grads)."""
    import dirt_tpu_torch
    background, clip, colors, faces, weights = scene
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (background, clip, colors)]
    pixels = dirt_tpu_torch.rasterise_batch(leaves[0], leaves[1], leaves[2],
                                            faces)
    (pixels * weights).sum().backward()
    return pixels.detach(), [x.grad for x in leaves]


def check_main_path(scene):
    import dirt_tpu_torch
    from dirt_tpu_torch.ops import _cuda, backward, dispatch
    from dirt_tpu_torch.utils import oracle
    background, clip, colors, faces, weights = scene

    _cuda.reset_counts()
    pixels, (g_bg, g_clip, g_colors) = step(scene)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    phase("main", f"launches in one step: {launches}")
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        fail(f"main path did not launch {idle}")

    px_aux, aux = dirt_tpu_torch.rasterise_batch_with_aux(
        background, clip, colors, faces)
    if not torch.equal(px_aux, pixels):
        fail("rasterise_batch_with_aux pixels differ from the step's")
    if int(aux.dropped.max()) != 0:
        fail(f"dropped visits: {aux.dropped.tolist()}")

    want_px, want_index = oracle.rasterise(
        background[0].cpu().numpy(), clip[0].cpu().numpy(),
        colors[0].cpu().numpy(), faces[0].cpu().numpy())
    if not np.array_equal(aux.face_index[0].cpu().numpy(), want_index):
        fail("winner map of image 0 differs from the native oracle")
    got_px = pixels[0].cpu().numpy()
    if not np.allclose(got_px, want_px, atol=1e-4, rtol=1e-5):
        fail(f"pixels of image 0 differ from the native oracle by up to "
             f"{np.abs(got_px - want_px).max()}")

    _, ref_aux = dispatch.forward_batch(background, clip, colors, faces,
                                        "reference")
    if not torch.equal(ref_aux.face_index, aux.face_index):
        fail("winner map differs from the reference backend on the card")

    want_bg, want_v, want_c = backward.rasterise_grad_grouped(
        clip, faces, pixels, weights, aux, implementation="xla")
    if not torch.equal(g_bg, want_bg):
        fail("grad_background differs from the plain gradient")
    for name, got, want in (("grad_vertices", g_clip, want_v),
                            ("grad_vertex_colors", g_colors, want_c)):
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} has non-finite values")
        scale = max(float(want.abs().max()), 1.0)
        err = float((got - want).abs().max()) / scale
        if not err <= GRAD_TOL:
            fail(f"{name} differs from the plain gradient: {err} > "
                 f"{GRAD_TOL} (normalised)")
    if not bool(torch.isfinite(g_bg).all()):
        fail("grad_background has non-finite values")
    phase("main", "oracle winner map == and pixels within 1e-4; reference "
          "winner map ==; gradients vs plain within 3e-6; finite; dropped 0")
    return launches


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
    card_line = card()
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_line}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 2. Build
    from dirt_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.load()
    phase("build", f"kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({_cuda.library_path().name})")

    # 3. Kernels vs plain
    scene = bench_scene(16, 256, 64, device)
    errors, calls = compare_kernels("bench 16x256^2x512f", scene)
    compare_kernels("100x100", bench_scene(4, 100, 64, device))
    compare_kernels("camera-crossing", crossing_scene(device))
    compare_kernels("1x256^2x8192f", bench_scene(1, 256, 1024, device))

    # 4. Main path
    launches = check_main_path(scene)

    # 5. Timing
    step_ms = time_ms(lambda: step(scene), STEPS)
    kernels = []
    for name, (kernel, plain) in calls.items():
        k = _cuda.KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"dirt_tpu_torch/csrc/{name}.cu",
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": time_ms(kernel, STEPS), "plain_ms": time_ms(plain, 5)})
        phase("timing", f"{name}: {kernels[-1]['ms']:.4f} ms, plain "
              f"{kernels[-1]['plain_ms']:.4f} ms")
    phase("timing", f"main path fwd+bwd 16x256^2x3, 512 faces: median "
          f"{step_ms:.4f} ms/step over {STEPS} steps on {card_line}")

    # 6. Result
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
