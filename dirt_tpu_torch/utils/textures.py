"""Differentiable texture sampling for deferred shading (PyTorch port of
dirt_tpu/utils/textures.py).

UV-to-pixel-index mapping (repeat or clamp addressing) and nearest or
bilinear texture sampling, differentiable with respect to the texture and
the indices.  Tensor arguments keep their device; arguments that are all
Python or numpy values go to ``device``, and without one to the CUDA card
(devices.py).  Clamping is max-then-min (gradient 0.5 at a tie, as
``jnp.clip``; ``torch.clamp`` gives 1).

Texels are gathered with ``index_select`` on the flattened texture, and
their gradient is ``index_add_``: advanced indexing's backward
(``index_put_(accumulate=True)``) sorts the indices on the card and sums
each texel's duplicates in one thread, and a shader samples one texel for
every background pixel.

The sampler is one autograd Function, so its two halves are stages of the
port's profiling (utils/profiling): the forward runs in the span
``dirt.texture.sample``, the backward in ``dirt.texture.sample_grad``,
where, while a profiler records, the counter ``texture.texels_touched``
gets the number of distinct texels the texture gradient scatters into.
The Function keeps only its two inputs for the backward (the texture, a
leaf the caller holds anyway, and the [..., 2] indices: 8 bytes a point)
and gathers the corner texels again there for the index gradient.
"""

import torch
from torch.autograd.function import once_differentiable

from ..devices import input_device
from . import profiling


def uvs_to_pixel_indices(uvs, texture_shape, mode='repeat', device=None):
    """Maps UV coordinates to (row, col) texture pixel indices.

    Assumes u = 0, v = 0 is at the top-left of the texture image (matching
    samples/textured.py:18 -- note this differs from the OpenGL convention).

    Args:
        uvs: [..., 2] float (u, v) coordinates.
        texture_shape: (height, width) of the texture.
        mode: 'repeat' (wrap) or 'clamp'.

    Returns:
        [..., 2] float (row, col) indices into the texture.
    """
    device = input_device((uvs, texture_shape), device)
    # (u, v) -> (v, u): row-ish, col-ish.
    uvs = torch.as_tensor(uvs, dtype=torch.float32, device=device).flip(-1)
    texture_shape = torch.as_tensor(texture_shape, dtype=torch.float32,
                                    device=device)
    if mode == 'repeat':
        return uvs % 1. * texture_shape
    if mode == 'clamp':
        clipped = torch.minimum(torch.maximum(uvs, torch.zeros_like(uvs)),
                                torch.ones_like(uvs))
        return clipped * texture_shape
    raise NotImplementedError(f"unknown addressing mode {mode!r}")


def _flat(r, c, w):
    """The flat texel ids [N] of (row, col) in a texture `w` texels wide."""
    return (r * w + c).reshape(-1)


def _nearest_corner(indices, h, w):
    """The texel (row, col) of each point in nearest mode: the indices
    truncated (as astype(int32)), then clamped."""
    idx = indices.to(torch.int64)
    return idx[..., 0].clamp(0, h - 1), idx[..., 1].clamp(0, w - 1)


def _bilinear_corners(indices, h, w):
    """(r0, c0, r1, c1, fr, fc) of each point in bilinear mode: the four
    corners' rows and columns, each clamped to the texture, and the
    fractions [..., 1] of the row and the column."""
    floor_indices = torch.floor(indices)
    frac = indices - floor_indices
    r0 = floor_indices[..., 0].to(torch.int64).clamp(0, h - 1)
    c0 = floor_indices[..., 1].to(torch.int64).clamp(0, w - 1)
    r1 = (r0 + 1).clamp(0, h - 1)
    c1 = (c0 + 1).clamp(0, w - 1)
    return r0, c0, r1, c1, frac[..., :1], frac[..., 1:]


class _SampleTexture(torch.autograd.Function):
    """texture [h, w, *C] sampled at indices [..., 2], nearest or bilinear;
    the gradients with respect to both.

    The texture gradient is ``index_add_`` of each corner's weighted
    output gradient into one zero [h * w, C] buffer.  In bilinear mode the
    index gradient is the fractions' alone (floor and the integer corners
    carry none): d/dr = sum_c g (-(1 - fc) T00 - fc T01 + (1 - fc) T10
    + fc T11) and d/dc = sum_c g (-(1 - fr) T00 + (1 - fr) T01 - fr T10
    + fr T11), each product grouped as autograd groups the forward's.
    Nearest mode has no index gradient."""

    @staticmethod
    def forward(ctx, texture, indices, bilinear):
        with profiling.span("dirt.texture.sample", texture):
            ctx.bilinear = bilinear
            ctx.save_for_backward(texture, indices)
            h, w = texture.shape[0], texture.shape[1]
            texels = texture.reshape(h * w, -1)

            def at(r, c):
                return texels.index_select(0, _flat(r, c, w)).reshape(
                    r.shape + texture.shape[2:])

            if not bilinear:
                return at(*_nearest_corner(indices, h, w))
            r0, c0, r1, c1, fr, fc = _bilinear_corners(indices, h, w)
            return (at(r0, c0) * (1. - fc) * (1. - fr)
                    + at(r0, c1) * fc * (1. - fr)
                    + at(r1, c0) * (1. - fc) * fr
                    + at(r1, c1) * fc * fr)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        texture, indices = ctx.saved_tensors
        want_texture, want_indices = ctx.needs_input_grad[:2]
        want_indices = want_indices and ctx.bilinear
        with profiling.span("dirt.texture.sample_grad", grad):
            h, w = texture.shape[0], texture.shape[1]
            texels = texture.reshape(h * w, -1)
            g = grad.reshape(-1, texels.shape[1])
            if ctx.bilinear:
                r0, c0, r1, c1, fr, fc = _bilinear_corners(indices, h, w)
                fr, fc = fr.reshape(-1, 1), fc.reshape(-1, 1)
                # (row, col, row weight, col weight, signs of the row's
                # and the column's fraction in the corner's weight)
                corners = ((r0, c0, 1. - fr, 1. - fc, -1., -1.),
                           (r0, c1, 1. - fr, fc, -1., 1.),
                           (r1, c0, fr, 1. - fc, 1., -1.),
                           (r1, c1, fr, fc, 1., 1.))
            else:
                r, c = _nearest_corner(indices, h, w)
                corners = ((r, c, None, None, 0., 0.),)
            grad_texels = (torch.zeros_like(texels) if want_texture
                           else None)
            touched = (torch.zeros(h * w, dtype=torch.bool,
                                   device=texels.device)
                       if want_texture and profiling.recording() else None)
            grad_r = grad_c = None
            for r, c, wr, wc, sign_r, sign_c in corners:
                index = _flat(r, c, w)
                gw = g if wr is None else g * wr
                if want_texture:
                    grad_texels.index_add_(0, index,
                                           gw if wc is None else gw * wc)
                if touched is not None:
                    touched.index_fill_(0, index, True)
                if want_indices:
                    corner = texels.index_select(0, index)
                    dr = sign_r * (g * (corner * wc)).sum(-1)
                    dc = sign_c * (gw * corner).sum(-1)
                    grad_r = dr if grad_r is None else grad_r + dr
                    grad_c = dc if grad_c is None else grad_c + dc
            if touched is not None:
                profiling.count("texture.texels_touched", touched)
        grad_texture = (None if grad_texels is None
                        else grad_texels.reshape(texture.shape))
        grad_indices = (None if not want_indices else
                        torch.stack([grad_r, grad_c], -1).reshape(
                            indices.shape))
        return grad_texture, grad_indices, None


def sample_texture(texture, indices, mode='bilinear', device=None):
    """Samples a texture at fractional pixel indices.

    Args:
        texture: [height, width, C] float.
        indices: [..., 2] float (row, col) indices.
        mode: 'nearest' or 'bilinear'.

    Returns:
        [..., C] sampled values, differentiable wrt texture and indices
        (bilinear mode).
    """
    device = input_device((texture, indices), device)
    texture = torch.as_tensor(texture, dtype=torch.float32, device=device)
    indices = torch.as_tensor(indices, dtype=torch.float32, device=device)
    if mode == 'nearest':
        # Truncation carries no gradient to the indices.
        return _SampleTexture.apply(texture, indices.detach(), False)
    if mode == 'bilinear':
        return _SampleTexture.apply(texture, indices, True)
    raise NotImplementedError(f"unknown sampling mode {mode!r}")
