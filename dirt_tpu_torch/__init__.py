"""dirt_tpu_torch: the PyTorch + CUDA port of dirt_tpu for NVIDIA Hopper.

A second package beside the JAX one: the same differentiable rasteriser
(homogeneous edge functions, top-left fill rule, per-fragment near/far
clip, lexicographic depth test, filter-based gradients with occluder
dilation), mirroring dirt_tpu's modules and function names.  On CUDA
tensors the main path runs four hand-written sm_90a kernels
(dirt_tpu_torch/csrc/); on CPU tensors it runs plain PyTorch.  It never
imports jax.

Public entry points: rasterise, rasterise_batch, rasterise_batch_with_aux,
plus the ``matrices`` helper module.
"""

from . import matrices
from .rasterise_ops import rasterise, rasterise_batch, rasterise_batch_with_aux

__all__ = [
    "rasterise",
    "rasterise_batch",
    "rasterise_batch_with_aux",
    "matrices",
]

__version__ = "0.1.0"
