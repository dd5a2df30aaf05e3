"""dirt_tpu_torch: the PyTorch + CUDA port of dirt_tpu for NVIDIA Hopper.

A second package beside the JAX one: the same differentiable rasteriser
(homogeneous edge functions, top-left fill rule, per-fragment near/far
clip, lexicographic depth test, filter-based gradients with occluder
dilation), mirroring dirt_tpu's modules and function names.  On CUDA
tensors the "blocks", "dense" and "pallas" backends and the "mxu"
gradient (DIRT_TPU_TORCH_GRAD_BACKEND=mxu) run twelve hand-written sm_90a
kernels (dirt_tpu_torch/csrc/); on CPU tensors they run plain PyTorch.
Entry points run on the card unless the caller passes CPU tensors or
device="cpu".  It never imports jax.

Public entry points: rasterise, rasterise_batch, rasterise_batch_with_aux,
rasterise_deferred, rasterise_batch_deferred, rasterise_grad_debug, plus
the helper modules ``matrices``, ``projection`` and ``lighting``
(``models`` holds the renderer pipelines, ``samples`` the sample programs,
``parallel`` batch and face sharding over torch.distributed).
"""

from . import lighting, matrices, projection
from .rasterise_ops import (rasterise, rasterise_batch,
                            rasterise_batch_deferred,
                            rasterise_batch_with_aux, rasterise_deferred,
                            rasterise_grad_debug)

__all__ = [
    "rasterise",
    "rasterise_batch",
    "rasterise_batch_with_aux",
    "rasterise_deferred",
    "rasterise_batch_deferred",
    "rasterise_grad_debug",
    "matrices",
    "projection",
    "lighting",
]

__version__ = "0.1.0"
