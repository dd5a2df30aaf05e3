"""Backend dispatch for the forward rasteriser (PyTorch port of
dirt_tpu/ops/dispatch.py).

Backends:
  * "blocks":    the block-binned schedule (ops/forward_blocks.py).  On
                 CUDA tensors its hit test and sweep run as the CUDA
                 kernels K4 and K1; on CPU tensors, as their plain
                 PyTorch versions.
  * "reference": brute-force sweep (ops/reference.py), the oracle.
  * None/"auto": chosen by the tensors' device -- "blocks" for CUDA,
                 "reference" for the CPU, the same defaults dirt_tpu uses
                 on its accelerator and on the CPU.  DIRT_TPU_TORCH_BACKEND
                 overrides the choice.

The gradient follows the forward's choice: "blocks" pairs with the
block-binned gradient (kernels K2 and K3), "reference" with the plain
scatter gradient ("xla", the name dirt_tpu gives it).  dirt_tpu's
"dense" and "pallas" backends are not ported yet (ROADMAP queue 2).
"""

import os

import torch

from . import reference

BACKENDS = ("blocks", "reference")
GRAD_FOR_BACKEND = {"blocks": "blocks", "reference": "xla"}


def default_backend(device):
    env = os.environ.get("DIRT_TPU_TORCH_BACKEND", "auto")
    if env != "auto":
        return env
    return "blocks" if torch.device(device).type == "cuda" else "reference"


def resolve_backend(backend, device):
    chosen = backend or default_backend(device)
    if chosen == "auto":
        chosen = default_backend(device)
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
    chosen = resolve_backend(backend, background.device)
    if chosen == "reference":
        return reference.rasterise_batch(
            background, vertices, vertex_colors, faces)
    from . import forward_blocks
    return forward_blocks.rasterise_batch(
        background, vertices, vertex_colors, faces)
