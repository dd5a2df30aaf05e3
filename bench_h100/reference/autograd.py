"""The two entry points of the benchmark's step under autograd, plain
PyTorch: the brute-force forward and the plain scatter gradient."""

import torch

from . import forward, gradient


class _Rasterise(torch.autograd.Function):

    @staticmethod
    def forward(ctx, background, vertices, colors, faces):
        pixels, aux = forward.rasterise_batch(background, vertices, colors,
                                              faces)
        ctx.save_for_backward(vertices, pixels, *aux)
        return pixels

    @staticmethod
    def backward(ctx, grad_pixels):
        vertices, pixels, *aux = ctx.saved_tensors
        grad_background, grad_vertices, grad_colors = gradient.grad_grouped(
            vertices, pixels, grad_pixels.contiguous(),
            forward.RasterAux(*aux))
        return grad_background, grad_vertices, grad_colors, None


def rasterise_batch(background, vertices, colors, faces):
    """Pixels [B, H, W, C], differentiable in the background, the
    vertices and the colours."""
    return _Rasterise.apply(background, vertices, colors, faces)


class _Shaded:
    """The shaded pixels and, once their backward ran, their cotangent."""

    def __init__(self):
        self.pixels = None
        self.grad_pixels = None


class _GBuffer(torch.autograd.Function):
    """Rasterises the G-buffer; the backward takes the vertex gradients
    from the shaded pixels' Scharr and the attribute and background
    gradients from the G-buffer's cotangent."""

    @staticmethod
    def forward(ctx, background, vertices, attributes, faces, shaded):
        gbuffer, aux = forward.rasterise_batch(background, vertices,
                                               attributes, faces)
        ctx.save_for_backward(vertices, *aux)
        ctx.shaded = shaded
        return gbuffer

    @staticmethod
    def backward(ctx, grad_gbuffer):
        vertices, *aux = ctx.saved_tensors
        pixels = ctx.shaded.pixels
        grad_pixels = ctx.shaded.grad_pixels
        if grad_pixels is None:
            grad_pixels = torch.zeros_like(pixels)
        grad_background, grad_vertices, grad_attributes = (
            gradient.grad_grouped(vertices, pixels, grad_pixels,
                                  forward.RasterAux(*aux),
                                  grad_gbuffer.contiguous()))
        return grad_background, grad_vertices, grad_attributes, None, None


class _ShadedPixels(torch.autograd.Function):
    """Identity on the shaded pixels that keeps them and their cotangent
    for _GBuffer's backward, which autograd runs after this one."""

    @staticmethod
    def forward(ctx, pixels, shaded):
        shaded.pixels = pixels.detach()
        ctx.shaded = shaded
        return pixels.view_as(pixels)

    @staticmethod
    def backward(ctx, grad_pixels):
        ctx.shaded.grad_pixels = grad_pixels.contiguous()
        return grad_pixels, None


def rasterise_batch_deferred(background, vertices, attributes, faces,
                             shader_fn):
    """shader_fn(G-buffer) with the deferred gradients."""
    shaded = _Shaded()
    gbuffer = _GBuffer.apply(background, vertices, attributes, faces, shaded)
    return _ShadedPixels.apply(shader_fn(gbuffer), shaded)
