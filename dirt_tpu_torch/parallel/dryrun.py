"""A dry run of every sharded path at tiny shapes (PyTorch port of
__graft_entry__.py's dryrun_multichip).

`dryrun_multichip(n)` spawns n ranks (launch.run_ranks) and runs, in
each, four passes (`rank_passes`), each of which must end on a finite
loss and finite new parameters or gradients, and records each pass's
loss and the kernels it launched:

  1. the data-parallel fit step (sharding.data_parallel_fit_step) of the
     flagship Gouraud-cube pipeline on the default backend, "dense" and
     "blocks", with DIRT_TPU_TORCH_GRAD_BACKEND set to the backend (and
     restored) as dirt_tpu's dry run sets DIRT_TPU_GRAD_BACKEND;
  2. the same step through the deferred Phong renderer (the deferred
     backward with a 10-channel G-buffer);
  3. the face-sharded render (face_sharding.rasterise_batch_face_sharded)
     of the cube with its faces padded by zero-index rows to a multiple
     of n, differentiated wrt vertices, colours and background.

Scene parameters are replicated, targets batch-sharded (two images a
rank), as dirt_tpu's dry run lays them out on its mesh.
"""

import contextlib

import numpy as np
import torch

import dirt_tpu_torch
from .. import lighting
from ..models import renderers
from ..ops import _cuda, dispatch
from ..samples import common
from ..utils import meshes
from . import face_sharding, launch, sharding

HEIGHT, WIDTH = 16, 32


def _cube_scene(device):
    vertices, faces = meshes.build_cube()
    vertices, faces = lighting.split_vertices_by_face(vertices, faces,
                                                      device=device)
    homogeneous = torch.cat([vertices, torch.ones_like(vertices[:, :1])],
                            dim=1)
    return homogeneous, faces


def _forward(rotation, translation, light_direction, background,
             backend=None):
    """The flagship pipeline, as __graft_entry__.py's _forward: the cube
    under samples/common.py's camera, with the camera translation and
    the light direction differentiable."""
    height, width = background.shape[0], background.shape[1]
    clip, faces, _, normals, _ = common.cube_scene(
        rotation, width, height, camera_translation=translation)
    lit = lighting.diffuse_directional(
        normals, torch.ones_like(normals), light_direction,
        [1., 1., 1.]) * 0.8 + 0.2
    return dirt_tpu_torch.rasterise(background, clip, lit, faces,
                                    backend=backend)


def _check(tag, loss, tensors):
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{tag}: loss {float(loss)} is not finite")
    for tensor in tensors:
        if not bool(torch.isfinite(tensor).all()):
            raise AssertionError(f"{tag}: non-finite parameters or "
                                 f"gradients")


def _counted(run):
    """run()'s loss, and the kernels this process launched in it (the
    counters reset first): {"loss": float, "launches": {kernel: n}}."""
    _cuda.reset_counts()
    loss = float(run())
    return {"loss": loss, "launches": {
        name: kernel.launches for name, kernel in _cuda.KERNELS.items()
        if kernel.launches}}


def rank_passes(n, device_type):
    """The four passes, on this rank of an n-rank group; returns {pass:
    _counted's record}, the passes named "fit None", "fit dense", "fit
    blocks", "deferred" and "face-sharded"."""
    device = torch.device(device_type, torch.cuda.current_device()
                          if device_type == "cuda" else None)
    mesh = sharding.make_mesh(n, device_type)
    vertices_h, faces = _cube_scene(device)
    params = sharding.replicated(mesh, {
        "rotation": torch.tensor([0., 0.4, 0.], device=device),
        "translation": torch.tensor([0., -1.5, -3.5], device=device),
        "light": torch.tensor([1., 0., 0.], device=device)})
    rng = np.random.RandomState(0)
    targets = sharding.batch_sharded(mesh, torch.tensor(
        rng.uniform(size=(2 * n, HEIGHT, WIDTH, 3)).astype(np.float32),
        device=device))
    background = torch.zeros(HEIGHT, WIDTH, 3, device=device)
    out = {}

    for backend in (None, "dense", "blocks"):
        def render_fn(p, shard, _backend=backend):
            pixels = _forward(p["rotation"], p["translation"], p["light"],
                              background, _backend)
            return pixels[None].expand(shard, -1, -1, -1)

        def fit(_backend=backend, _render_fn=render_fn):
            with (contextlib.nullcontext() if _backend is None
                  else dispatch.grad_env_set(_backend)):
                new_params, loss = sharding.data_parallel_fit_step(
                    mesh, _render_fn, params, targets, learning_rate=1e-3)
            _check(f"backend {_backend}", loss, new_params.values())
            return loss
        out[f"fit {backend}"] = _counted(fit)

    renderer = renderers.DeferredPhongRenderer(width=WIDTH, height=HEIGHT)
    v_obj, d_faces = meshes.build_cube()
    v_obj, d_faces = lighting.split_vertices_by_face(v_obj, d_faces,
                                                     device=device)
    albedo = torch.full((v_obj.shape[0], 3), 0.7, device=device)

    def render_deferred(p, shard):
        image = renderer.render(v_obj, d_faces, albedo, p["rotation"],
                                p["light"])
        return image[None].expand(shard, -1, -1, -1)

    def deferred():
        new_params, loss = sharding.data_parallel_fit_step(
            mesh, render_deferred, params, targets, learning_rate=1e-3)
        _check("deferred", loss, new_params.values())
        return loss
    out["deferred"] = _counted(deferred)

    f_mesh = face_sharding.make_face_mesh(n, device_type)
    rng = np.random.RandomState(1)
    pad = (-faces.shape[0]) % n
    faces_pad = torch.cat([faces, torch.zeros(pad, 3, dtype=torch.int32,
                                              device=device)])
    uniform = lambda *shape: torch.tensor(
        rng.uniform(size=shape).astype(np.float32), device=device)
    leaves = [vertices_h[None].clone().requires_grad_(True),
              uniform(1, vertices_h.shape[0], 3).requires_grad_(True),
              uniform(1, HEIGHT, WIDTH, 3).requires_grad_(True)]
    weights = uniform(1, HEIGHT, WIDTH, 3)

    def face_sharded():
        loss = torch.sum(face_sharding.rasterise_batch_face_sharded(
            f_mesh, leaves[2], leaves[0], leaves[1], faces_pad[None])
            * weights)
        loss.backward()
        _check("face-sharded", loss.detach(), [x.grad for x in leaves])
        return loss.detach()
    out["face-sharded"] = _counted(face_sharded)
    return out


def dryrun_multichip(n, device=None):
    """Runs the dry run on n ranks over gloo, with tensors on `device`
    (default: the card; every rank may share one).  Raises if a rank
    fails; returns each rank's rank_passes record."""
    device_type = torch.device(device or "cuda").type
    return launch.run_ranks(n, rank_passes, (n, device_type),
                            backend="gloo", device=device_type)
