"""Public differentiable rasterisation API (PyTorch port of
dirt_tpu/rasterise_ops.py).

  * ``rasterise`` / ``rasterise_batch``: rasterisation with the analytic
    filter-based gradients, through one ``torch.autograd.Function`` whose
    residuals are (vertices, faces, pixels, aux) -- the counterpart of the
    JAX package's ``jax.custom_vjp``.
  * ``rasterise_batch_with_aux``: the forward with its per-pixel aux
    diagnostics (including ``dropped``), outside autograd.

Argument order, layouts and dtypes are dirt_tpu's: [B, H, W, C] float32
images, [B, V, 4] clip-space vertices, [B, V, C] vertex colours, [B, F, 3]
int32 faces.  Gradients flow to the background, the vertices (x, y and w;
z always gets 0) and the vertex colours, never to the faces.

The backend is chosen by the tensors' device (ops/dispatch.py): CUDA
tensors run the block-binned schedule through the four CUDA kernels, CPU
tensors the brute-force reference and the plain scatter gradient.  The
gradient follows the forward's backend.  The deferred-shading entry
points and rasterise_grad_debug are not ported yet (ROADMAP).
"""

import torch

from .ops import backward as _backward
from .ops import dispatch as _dispatch
from .ops.reference import RasterAux


def _as_inputs(background, vertices, vertex_colors, faces):
    device = next((t.device for t in (background, vertices, vertex_colors,
                                      faces)
                   if isinstance(t, torch.Tensor)), None)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(background), f32(vertices), f32(vertex_colors),
            torch.as_tensor(faces, dtype=torch.int32, device=device))


class _RasteriseBatch(torch.autograd.Function):
    """Forward through dispatch.forward_batch; backward through
    backward.rasterise_grad_grouped on the saved residuals."""

    @staticmethod
    def forward(ctx, background, vertices, vertex_colors, faces, backend):
        pixels, aux = _dispatch.forward_batch(
            background, vertices, vertex_colors, faces, backend)
        ctx.save_for_backward(vertices, faces, pixels, aux.face_index,
                              aux.indices, aux.barycentric, aux.clip_w)
        ctx.grad_implementation = _dispatch.GRAD_FOR_BACKEND[backend]
        return pixels

    @staticmethod
    def backward(ctx, grad_pixels):
        vertices, faces, pixels, *aux = ctx.saved_tensors
        grad_background, grad_vertices, grad_vertex_colors = (
            _backward.rasterise_grad_grouped(
                vertices, faces, pixels, grad_pixels.contiguous(),
                RasterAux(*aux), implementation=ctx.grad_implementation))
        return grad_background, grad_vertices, grad_vertex_colors, None, None


def rasterise_batch(background, vertices, vertex_colors, faces, height=None,
                    width=None, channels=None, backend=None):
    """Rasterises a batch of meshes with common vertex/face counts.

    Args:
        background: float32 [batch, height, width, channels].
        vertices: float32 [batch, vertex count, 4] clip-space positions.
        vertex_colors: float32 [batch, vertex count, channels].
        faces: int32 [batch, face count, 3] vertex-index triples.
        height, width, channels: optional ints, validated against the
            background's shape.
        backend: optional "blocks" | "reference" override (see
            ops/dispatch.py); None chooses by device.

    Returns:
        float32 [batch, height, width, channels] pixels, top row first,
        differentiable wrt background, vertices and vertex_colors.
    """
    background, vertices, vertex_colors, faces = _as_inputs(
        background, vertices, vertex_colors, faces)
    _check_hwc(background, height, width, channels)
    chosen = _dispatch.resolve_backend(backend, background.device)
    return _RasteriseBatch.apply(background, vertices, vertex_colors, faces,
                                 chosen)


def rasterise(background, vertices, vertex_colors, faces, height=None,
              width=None, channels=None, backend=None):
    """Single-image ``rasterise_batch`` (no batch dimension anywhere)."""
    background, vertices, vertex_colors, faces = _as_inputs(
        background, vertices, vertex_colors, faces)
    return rasterise_batch(background[None], vertices[None],
                           vertex_colors[None], faces[None], height, width,
                           channels, backend)[0]


def rasterise_batch_with_aux(background, vertices, vertex_colors, faces,
                             backend=None):
    """Forward rasterisation returning (pixels, RasterAux) for a batch.

    RasterAux carries the backward residuals (face index map, vertex-index
    triples, barycentrics, clip w) and ``dropped``, the per-image count of
    face visits the blocks schedule's slot budget could not hold (0 means
    the render is exact).  A diagnostic surface: the pixels are not
    attached to autograd (use ``rasterise_batch`` to train).
    """
    with torch.no_grad():
        return _dispatch.forward_batch(
            *_as_inputs(background, vertices, vertex_colors, faces), backend)


def _check_hwc(background, height, width, channels):
    for name, want, got in (("height", height, background.shape[-3]),
                            ("width", width, background.shape[-2]),
                            ("channels", channels, background.shape[-1])):
        if want is not None and got != want:
            raise ValueError(f"{name} {want} != background {name} {got}")
