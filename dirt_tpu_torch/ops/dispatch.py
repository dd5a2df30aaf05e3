"""Backend dispatch for the forward rasteriser (PyTorch port of
dirt_tpu/ops/dispatch.py).

Backends:
  * "blocks":    the block-binned schedule (ops/forward_blocks.py).  On
                 CUDA tensors its hit test and sweep run as the CUDA
                 kernels K4 and K1; on CPU tensors, as their plain
                 PyTorch versions.
  * "dense":     exact per-tile face lists (ops/forward_dense.py).  On
                 CUDA tensors its sweep runs as the CUDA kernel K7.
  * "pallas":    the same lists, swept and shaded in one kernel
                 (ops/forward_pallas.py, K8 on CUDA) that writes the
                 pixels and aux directly; equal to "dense" bit for bit.
  * "reference": brute-force sweep (ops/reference.py), the oracle.
  * None/"auto": chosen by the tensors' device -- "blocks" for CUDA,
                 "reference" for the CPU, the same defaults dirt_tpu uses
                 on its accelerator and on the CPU.  On CUDA a non-zero
                 DIRT_TPU_TORCH_BLOCKS_THRESHOLD chooses "dense" for
                 meshes of at most that many faces, as dirt_tpu's
                 DIRT_TPU_BLOCKS_THRESHOLD does; its default 0 keeps
                 "blocks", since no H100 measurement yet favours "dense"
                 at any face count.  DIRT_TPU_TORCH_BACKEND overrides the
                 choice.

The gradient follows the forward's choice: "blocks" pairs with the
block-binned gradient (kernels K2 and K3), "dense" with the tile-major
dense gradient (kernels K2 and K9), "pallas" with the block-binned one
too (dirt_tpu's gradient name "pallas" resolves to its blocks kernel),
"reference" with the plain scatter gradient ("xla", the name dirt_tpu
gives it).  DIRT_TPU_TORCH_GRAD_BACKEND, when set and not "auto",
overrides the pairing (grad_for_backend), as dirt_tpu's
DIRT_TPU_GRAD_BACKEND overrides its automatic choice: it is how a
training step reaches the "mxu" gradient.
"""

import contextlib
import os

import torch

from . import reference

BACKENDS = ("blocks", "dense", "pallas", "reference")
GRAD_FOR_BACKEND = {"blocks": "blocks", "dense": "dense", "pallas": "blocks",
                    "reference": "xla"}


def default_backend(device, num_faces=None):
    env = os.environ.get("DIRT_TPU_TORCH_BACKEND", "auto")
    if env != "auto":
        return env
    if torch.device(device).type != "cuda":
        return "reference"
    threshold = int(os.environ.get("DIRT_TPU_TORCH_BLOCKS_THRESHOLD", "0"))
    if num_faces is not None and num_faces <= threshold:
        return "dense"
    return "blocks"


def grad_env():
    """The gradient that DIRT_TPU_TORCH_GRAD_BACKEND names, default "auto"
    (the one place the port reads it)."""
    return os.environ.get("DIRT_TPU_TORCH_GRAD_BACKEND", "auto")


@contextlib.contextmanager
def grad_env_set(name):
    """Within the block, DIRT_TPU_TORCH_GRAD_BACKEND is `name`."""
    saved = os.environ.get("DIRT_TPU_TORCH_GRAD_BACKEND")
    os.environ["DIRT_TPU_TORCH_GRAD_BACKEND"] = name
    try:
        yield
    finally:
        if saved is None:
            del os.environ["DIRT_TPU_TORCH_GRAD_BACKEND"]
        else:
            os.environ["DIRT_TPU_TORCH_GRAD_BACKEND"] = saved


def grad_for_backend(backend):
    """The gradient implementation a backend's autograd backward runs:
    grad_env() when not "auto", else the backend's pairing
    (GRAD_FOR_BACKEND)."""
    env = grad_env()
    return GRAD_FOR_BACKEND[backend] if env == "auto" else env


def resolve_backend(backend, device, num_faces=None):
    chosen = backend or default_backend(device, num_faces)
    if chosen == "auto":
        chosen = default_backend(device, num_faces)
    if chosen not in BACKENDS:
        raise ValueError(f"unknown backend {chosen!r}; expected one of "
                         f"{BACKENDS} or None/'auto'")
    return chosen


def forward_batch(background, vertices, vertex_colors, faces, backend=None):
    """Rasterises a batch; returns (pixels [B,H,W,C], RasterAux [B,...])."""
    if background.dim() != 4:
        raise ValueError(f"background must be [B,H,W,C], got "
                         f"{tuple(background.shape)}")
    if vertices.dim() != 3 or vertices.shape[-1] != 4:
        raise ValueError(f"vertices must be [B,V,4], got "
                         f"{tuple(vertices.shape)}")
    if faces.dim() != 3 or faces.shape[-1] != 3:
        raise ValueError(f"faces must be [B,F,3], got {tuple(faces.shape)}")
    if vertex_colors.shape[:2] != vertices.shape[:2]:
        raise ValueError(
            f"vertex_colors {tuple(vertex_colors.shape)} does not match "
            f"vertices {tuple(vertices.shape)}")
    if vertex_colors.shape[-1] != background.shape[-1]:
        raise ValueError(
            f"channel mismatch: vertex_colors {tuple(vertex_colors.shape)} "
            f"vs background {tuple(background.shape)}")
    devices = {t.device for t in (background, vertices, vertex_colors, faces)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")

    background = background.float().contiguous()
    vertices = vertices.float().contiguous()
    vertex_colors = vertex_colors.float().contiguous()
    faces = faces.to(torch.int32).contiguous()
    chosen = resolve_backend(backend, background.device, faces.shape[1])
    if chosen == "reference":
        return reference.rasterise_batch(
            background, vertices, vertex_colors, faces)
    if chosen == "dense":
        from . import forward_dense
        return forward_dense.rasterise_batch(
            background, vertices, vertex_colors, faces)
    if chosen == "pallas":
        from . import forward_pallas
        return forward_pallas.rasterise_batch(
            background, vertices, vertex_colors, faces)
    from . import forward_blocks
    return forward_blocks.rasterise_batch(
        background, vertices, vertex_colors, faces)
