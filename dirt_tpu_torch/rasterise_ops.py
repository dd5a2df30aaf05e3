"""Public differentiable rasterisation API (PyTorch port of
dirt_tpu/rasterise_ops.py).

  * ``rasterise`` / ``rasterise_batch``: rasterisation with the analytic
    filter-based gradients, through one ``torch.autograd.Function`` whose
    residuals are (vertices, faces, pixels, aux) -- the counterpart of the
    JAX package's ``jax.custom_vjp``.
  * ``rasterise_deferred`` / ``rasterise_batch_deferred``: deferred
    shading.  A G-buffer of vertex attributes is rasterised, a shader turns
    it into pixels, and the backward takes the vertex gradients from
    Scharr-filtering the SHADED pixels and the attribute / background
    gradients from the shader-chained G-buffer cotangent, in one fused
    sweep (backward.rasterise_grad_deferred).
  * ``rasterise_batch_with_aux``: the forward with its per-pixel aux
    diagnostics (including ``dropped``), outside autograd.
  * ``rasterise_grad_debug``: the gradient assembly with its debug image.

Argument order, layouts and dtypes are dirt_tpu's: [B, H, W, C] float32
images, [B, V, 4] clip-space vertices, [B, V, C] vertex colours, [B, F, 3]
int32 faces.  Gradients flow to the background, the vertices (x, y and w;
z always gets 0) and the vertex colours, never to the faces.

Every entry point runs on the CUDA card unless the caller asks for the
CPU: tensor inputs keep their device (mixed devices raise); numpy arrays
and Python values go to ``device``, and without one to the card
(devices.py).  The backend is chosen by the device (ops/dispatch.py):
CUDA tensors run the block-binned schedule through the CUDA kernels, CPU
tensors the brute-force reference and the plain scatter gradient;
``backend="dense"`` picks the tile-list backend and ``backend="pallas"``
the fused sweep-and-shade kernel over the same lists.  The gradient
follows the forward's backend, unless DIRT_TPU_TORCH_GRAD_BACKEND names
another ("xla", "blocks", "dense" or "mxu", the tensor-core masked sums
of ops/grad_mxu.py).

Under a torch.profiler session the autograd Functions record the entry
spans dirt.forward and dirt.backward, and the deferred pair the shader's
call as dirt.shade (utils/profiling); the blocks path records its stages
inside them, the other backends none.
"""

import torch

from .devices import input_device
from .ops import backward as _backward
from .ops import dispatch as _dispatch
from .ops.reference import RasterAux
from .utils import profiling


def _as_inputs(background, vertices, vertex_colors, faces, device=None):
    device = input_device((background, vertices, vertex_colors, faces),
                          device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(background), f32(vertices), f32(vertex_colors),
            torch.as_tensor(faces, dtype=torch.int32, device=device))


def _aux_tensors(aux):
    """The RasterAux fields a backward needs, to save for it."""
    return (aux.face_index, aux.indices, aux.barycentric, aux.clip_w)


class _RasteriseBatch(torch.autograd.Function):
    """Forward through dispatch.forward_batch; backward through
    backward.rasterise_grad_grouped on the saved residuals."""

    @staticmethod
    def forward(ctx, background, vertices, vertex_colors, faces, backend):
        with profiling.span("dirt.forward", vertices):
            pixels, aux = _dispatch.forward_batch(
                background, vertices, vertex_colors, faces, backend)
            ctx.save_for_backward(vertices, faces, pixels,
                                  *_aux_tensors(aux))
            ctx.grad_implementation = _dispatch.grad_for_backend(backend)
        return pixels

    @staticmethod
    def backward(ctx, grad_pixels):
        with profiling.span("dirt.backward", grad_pixels):
            vertices, faces, pixels, *aux = ctx.saved_tensors
            grad_background, grad_vertices, grad_vertex_colors = (
                _backward.rasterise_grad_grouped(
                    vertices, faces, pixels, grad_pixels.contiguous(),
                    RasterAux(*aux), implementation=ctx.grad_implementation))
        return grad_background, grad_vertices, grad_vertex_colors, None, None


def rasterise_batch(background, vertices, vertex_colors, faces, height=None,
                    width=None, channels=None, backend=None, device=None):
    """Rasterises a batch of meshes with common vertex/face counts.

    Args:
        background: float32 [batch, height, width, channels].
        vertices: float32 [batch, vertex count, 4] clip-space positions.
        vertex_colors: float32 [batch, vertex count, channels].
        faces: int32 [batch, face count, 3] vertex-index triples.
        height, width, channels: optional ints, validated against the
            background's shape.
        backend: optional "blocks" | "dense" | "pallas" | "reference"
            override (see ops/dispatch.py); None chooses by device.
        device: where inputs that are not tensors go (default: the CUDA
            card); tensors keep their own device.

    Returns:
        float32 [batch, height, width, channels] pixels, top row first,
        differentiable wrt background, vertices and vertex_colors.
    """
    background, vertices, vertex_colors, faces = _as_inputs(
        background, vertices, vertex_colors, faces, device)
    _check_hwc(background, height, width, channels)
    chosen = _dispatch.resolve_backend(backend, background.device,
                                       faces.shape[1])
    return _RasteriseBatch.apply(background, vertices, vertex_colors, faces,
                                 chosen)


def rasterise(background, vertices, vertex_colors, faces, height=None,
              width=None, channels=None, backend=None, device=None):
    """Single-image ``rasterise_batch`` (no batch dimension anywhere)."""
    background, vertices, vertex_colors, faces = _as_inputs(
        background, vertices, vertex_colors, faces, device)
    return rasterise_batch(background[None], vertices[None],
                           vertex_colors[None], faces[None], height, width,
                           channels, backend)[0]


def rasterise_batch_with_aux(background, vertices, vertex_colors, faces,
                             backend=None, device=None):
    """Forward rasterisation returning (pixels, RasterAux) for a batch.

    RasterAux carries the backward residuals (face index map, vertex-index
    triples, barycentrics, clip w) and ``dropped``, the per-image count of
    face visits the schedule could not hold -- the blocks backend's slot
    budget, the dense and pallas backends' per-tile face cap (0 means the
    render is exact).  A diagnostic surface: the pixels are not attached
    to autograd (use ``rasterise_batch`` to train).
    """
    with torch.no_grad():
        return _dispatch.forward_batch(
            *_as_inputs(background, vertices, vertex_colors, faces, device),
            backend)


def rasterise_grad_debug(background, vertices, vertex_colors, faces,
                         grad_pixels, backend=None, grad_implementation=None,
                         device=None):
    """Runs the gradient assembly with its debug output exposed.

    All arguments are single-image.  Returns (RasteriseGrads with
    unbatched fields, debug), `debug` a [height, width, 3] image whose
    channel 0 marks pixels dilated to an occluder (1e-2) and channels 1/2
    echo the cotangent's channels 1/2 (backward.debug_image).
    `grad_implementation` names the gradient path: "xla", "blocks",
    "dense", "mxu", "pallas" (the automatic kernel choice, "blocks") or
    None (DIRT_TPU_TORCH_GRAD_BACKEND, else the device's default); unknown
    names raise ValueError.
    """
    device = input_device(
        (background, vertices, vertex_colors, faces, grad_pixels), device)
    background, vertices, vertex_colors, faces = _as_inputs(
        background, vertices, vertex_colors, faces, device)
    grad_pixels = torch.as_tensor(grad_pixels, dtype=torch.float32,
                                  device=device)
    with torch.no_grad():
        pixels, aux = _dispatch.forward_batch(
            background[None], vertices[None], vertex_colors[None],
            faces[None], backend)
        grads = _backward.rasterise_grad_batch(
            vertices[None], faces[None], pixels, grad_pixels[None], aux,
            implementation=grad_implementation)
    unbatched = _backward.RasteriseGrads(*(field[0] for field in grads))
    return unbatched, unbatched.debug


def _check_hwc(background, height, width, channels):
    for name, want, got in (("height", height, background.shape[-3]),
                            ("width", width, background.shape[-2]),
                            ("channels", channels, background.shape[-1])):
        if want is not None and got != want:
            raise ValueError(f"{name} {want} != background {name} {got}")


# ---------------------------------------------------------------------------
# Deferred shading
# ---------------------------------------------------------------------------

class _ShadedCotangent:
    """What the shaded-pixel identity hands the G-buffer rasteriser: the
    shaded pixels and, once its backward has run, their cotangent."""

    def __init__(self):
        self.pixels = None
        self.grad_pixels = None


class _RasteriseGBuffer(torch.autograd.Function):
    """Rasterises the G-buffer; its backward runs the fused deferred
    gradient with the shaded pixels' cotangent that _ShadedPixels stashed
    (zeros if the shaded pixels were off the loss path)."""

    @staticmethod
    def forward(ctx, background, vertices, attributes, faces, backend,
                shaded):
        with profiling.span("dirt.forward", vertices):
            gbuffer, aux = _dispatch.forward_batch(
                background, vertices, attributes, faces, backend)
            ctx.save_for_backward(vertices, faces, gbuffer,
                                  *_aux_tensors(aux))
            ctx.grad_implementation = _dispatch.grad_for_backend(backend)
            ctx.shaded = shaded
        return gbuffer

    @staticmethod
    def backward(ctx, grad_gbuffer):
        with profiling.span("dirt.backward", grad_gbuffer):
            vertices, faces, gbuffer, *aux = ctx.saved_tensors
            pixels = ctx.shaded.pixels
            grad_pixels = ctx.shaded.grad_pixels
            if grad_pixels is None:
                grad_pixels = torch.zeros_like(pixels)
            grad_background, grad_vertices, grad_attributes = (
                _backward.rasterise_grad_deferred(
                    vertices, faces, pixels, grad_pixels, gbuffer,
                    grad_gbuffer.contiguous(), RasterAux(*aux),
                    implementation=ctx.grad_implementation))
        return (grad_background, grad_vertices, grad_attributes, None, None,
                None)


class _ShadedPixels(torch.autograd.Function):
    """An identity on the shaded pixels that keeps them, and in its
    backward their cotangent, for _RasteriseGBuffer's backward.  Autograd
    runs this backward first: the G-buffer's cotangent comes through the
    shader, downstream of it."""

    @staticmethod
    def forward(ctx, pixels, shaded):
        shaded.pixels = pixels.detach()
        ctx.shaded = shaded
        return pixels.view_as(pixels)

    @staticmethod
    def backward(ctx, grad_pixels):
        ctx.shaded.grad_pixels = grad_pixels.contiguous()
        return grad_pixels, None


def rasterise_batch_deferred(background_attributes, vertices,
                             vertex_attributes, faces, shader_fn,
                             shader_additional_inputs=(), backend=None,
                             device=None):
    """Rasterises a G-buffer of vertex attributes, then shades it per pixel.

    Returns ``shader_fn(gbuffer, *shader_additional_inputs)`` [batch,
    height, width, channels], where gbuffer [batch, height, width, attrs]
    is rasterise_batch(background_attributes, vertices, vertex_attributes,
    faces), with the deferred gradients: vertex gradients from
    Scharr-filtering the shaded pixels, attribute and background gradients
    chained through the shader.  The shader runs under ordinary autograd,
    so tensors it closes over, and shader_additional_inputs, get their
    gradients as anywhere else.
    """
    background, vertices, attributes, faces = _as_inputs(
        background_attributes, vertices, vertex_attributes, faces, device)
    chosen = _dispatch.resolve_backend(backend, background.device,
                                       faces.shape[1])
    shaded = _ShadedCotangent()
    gbuffer = _RasteriseGBuffer.apply(background, vertices, attributes,
                                      faces, chosen, shaded)
    with profiling.span("dirt.shade", gbuffer):
        pixels = shader_fn(gbuffer, *shader_additional_inputs)
    return _ShadedPixels.apply(pixels, shaded)


def rasterise_deferred(background_attributes, vertices, vertex_attributes,
                       faces, shader_fn, shader_additional_inputs=(),
                       backend=None, device=None):
    """Single-image deferred shading; see ``rasterise_batch_deferred``.
    ``shader_fn`` takes an unbatched G-buffer [height, width, attrs]."""
    background, vertices, attributes, faces = _as_inputs(
        background_attributes, vertices, vertex_attributes, faces, device)
    batched_shader = lambda gbuffer, *inputs: shader_fn(gbuffer[0],
                                                        *inputs)[None]
    return rasterise_batch_deferred(
        background[None], vertices[None], attributes[None], faces[None],
        batched_shader, shader_additional_inputs, backend)[0]
