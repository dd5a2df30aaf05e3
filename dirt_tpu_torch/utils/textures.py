"""Differentiable texture sampling for deferred shading (PyTorch port of
dirt_tpu/utils/textures.py).

UV-to-pixel-index mapping (repeat or clamp addressing) and nearest or
bilinear texture sampling, differentiable with respect to the texture and
the indices.  Tensor arguments keep their device; arguments that are all
Python or numpy values go to ``device``, and without one to the CUDA card
(devices.py).  Clamping is max-then-min (gradient 0.5 at a tie, as
``jnp.clip``; ``torch.clamp`` gives 1).

Texels are gathered with ``index_select`` on the flattened texture, whose
backward is ``index_add_``: advanced indexing's backward
(``index_put_(accumulate=True)``) sorts the indices on the card and sums
each texel's duplicates in one thread, and a shader samples one texel for
every background pixel.
"""

import torch

from ..devices import input_device


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
    h, w = texture.shape[0], texture.shape[1]

    texels = texture.reshape(h * w, -1)

    def at(r, c):
        flat = (r * w + c).reshape(-1)
        return texels.index_select(0, flat).reshape(
            r.shape + texture.shape[2:])

    if mode == 'nearest':
        idx = indices.to(torch.int64)          # truncates, as astype(int32)
        r = idx[..., 0].clamp(0, h - 1)
        c = idx[..., 1].clamp(0, w - 1)
        return at(r, c)

    if mode == 'bilinear':
        floor_indices = torch.floor(indices)
        frac = indices - floor_indices
        r0 = floor_indices[..., 0].to(torch.int64).clamp(0, h - 1)
        c0 = floor_indices[..., 1].to(torch.int64).clamp(0, w - 1)
        r1 = (r0 + 1).clamp(0, h - 1)
        c1 = (c0 + 1).clamp(0, w - 1)
        fr = frac[..., :1]
        fc = frac[..., 1:]
        return (at(r0, c0) * (1. - fc) * (1. - fr)
                + at(r0, c1) * fc * (1. - fr)
                + at(r1, c0) * (1. - fc) * fr
                + at(r1, c1) * fc * fr)

    raise NotImplementedError(f"unknown sampling mode {mode!r}")
