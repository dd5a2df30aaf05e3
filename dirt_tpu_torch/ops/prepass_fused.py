"""The gradient pre-pass and its tile-major plane stack (PyTorch port of
dirt_tpu/ops/prepass_fused.py).

plane_stack computes, per pixel, what backward.grad_prepass computes --
Scharr filtering, the occluder dilation (the two axial attempts, and the
four diagonal ones when backward.DIAGONAL is set) and the viewport
factors -- and writes the plane stack of grad_dense.plane_layout directly
in the tile-major [B*T, np_dma, tile_h*tile_w] layout the block-binned
gradient reduction reads.  On CUDA tensors this is kernel K2; on CPU
tensors, its plain version (grad_dense.prepass_and_planes + tile_planes).

Unlike the TPU kernel, the CUDA kernel reads each pixel's 3x3 and
4-neighbour views from device memory, so there is no whole-image residency
limit and no fallback: any image size is accepted, and pixels of the
padded tile grid past the image edge, like the pad planes, are written as
zeros (their face_d of 0.0 matches face 0, and only zero products keep
them harmless).
"""

import torch

from . import _cuda, backward, grad_dense

GRAD_PREPASS = _cuda.Kernel(
    "grad_prepass", "dirt_grad_prepass",
    [_cuda.ptr] * 9 + [_cuda.i32] * 12 + [_cuda.ptr],
    replaces="dirt_tpu/ops/prepass_fused.py:70", source="grad_prepass.cu")


def _cdiv(a, b):
    return -(-a // b)


def tile_planes(planes, tile_h, tile_w, np_dma):
    """[B, NP, H, W] -> tile-major [B*T, np_dma, tile_h*tile_w], zero-padded
    to whole tiles and to np_dma planes."""
    batch, n_planes, height, width = planes.shape
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    planes = torch.nn.functional.pad(
        planes, (0, tiles_x * tile_w - width, 0, tiles_y * tile_h - height))
    planes = planes.reshape(batch, n_planes, tiles_y, tile_h, tiles_x, tile_w)
    planes = planes.permute(0, 2, 4, 1, 3, 5).reshape(
        batch * tiles_y * tiles_x, n_planes, tile_h * tile_w)
    return torch.nn.functional.pad(planes, (0, 0, 0, np_dma - n_planes))


def plane_stack_plain(pixels, grad_pixels, aux, tile_h, tile_w, np_dma,
                      parts="all", color_cotangent=None):
    planes, _, dilated = grad_dense.prepass_and_planes(
        pixels, grad_pixels, aux, parts, color_cotangent)
    return tile_planes(planes, tile_h, tile_w, np_dma), dilated


def plane_stack(pixels, grad_pixels, aux, tile_h, tile_w, np_dma,
                parts="all", color_cotangent=None):
    """Pre-pass for a batch ([B, H, W, C] pixels / grad_pixels, RasterAux).

    Returns (planes [B*T, np_dma, tile_h*tile_w] float32 in
    grad_dense.plane_layout(parts) order, dilated [B, H, W] bool).
    `parts` is "all" or "position" ("color" needs no pre-pass).
    `color_cotangent` (parts="all" only) supplies the cotangent planes.
    """
    if parts not in ("all", "position"):
        raise ValueError(f"plane_stack builds 'all' or 'position' stacks, "
                         f"not {parts!r}")
    if not _cuda.on_cuda(pixels, grad_pixels, aux.barycentric):
        return plane_stack_plain(pixels, grad_pixels, aux, tile_h, tile_w,
                                 np_dma, parts, color_cotangent)
    batch, height, width, channels = pixels.shape
    cot = grad_pixels if color_cotangent is None else color_cotangent
    cot_channels = cot.shape[-1]
    n_planes = grad_dense.plane_layout(parts, cot_channels)[0]
    if np_dma < n_planes:
        raise ValueError(f"np_dma {np_dma} < {n_planes} planes")
    tiles_y, tiles_x = _cdiv(height, tile_h), _cdiv(width, tile_w)
    num_tiles = tiles_y * tiles_x
    device = pixels.device
    planes = torch.empty(batch * num_tiles, np_dma, tile_h * tile_w,
                         device=device)
    dilated = torch.empty(batch, height, width, dtype=torch.bool,
                          device=device)
    hw = (batch, height, width)
    GRAD_PREPASS(
        _cuda.check("pixels", pixels, torch.float32),
        _cuda.check("grad_pixels", grad_pixels, torch.float32,
                    hw + (channels,)),
        _cuda.check("cotangent", cot, torch.float32, hw + (cot_channels,)),
        _cuda.check("barycentric", aux.barycentric, torch.float32, hw + (3,)),
        _cuda.check("indices", aux.indices, torch.int32, hw + (3,)),
        _cuda.check("clip_w", aux.clip_w, torch.float32, hw),
        _cuda.check("face_index", aux.face_index, torch.int32, hw),
        _cuda.check("planes", planes, torch.float32),
        _cuda.check("dilated", dilated, torch.bool),
        batch, height, width, channels, cot_channels, tile_h, tile_w,
        tiles_x, num_tiles, np_dma, int(parts == "all"),
        int(backward.DIAGONAL), _cuda.stream())
    return planes, dilated


def gradient_planes(pixels, grad_pixels, aux, parts, color_cotangent,
                    tile_h, tile_w):
    """The tile-major plane stack a gradient reduction reads, with the
    background gradient and the dilation mask: (planes [B*T, np_dma, PIX]
    in grad_dense.plane_layout(parts) order, np_dma the plane count
    rounded up to 8; grad_background [B, H, W, C']; dilated [B, H, W]).

    parts "all" / "position" build it with plane_stack (kernel K2 on
    CUDA); parts "color" needs no Scharr or dilation and tiles the plain
    pre-pass."""
    channels = (grad_pixels if color_cotangent is None
                else color_cotangent).shape[-1]
    n_planes = grad_dense.plane_layout(parts, channels)[0]
    np_dma = _cdiv(n_planes, 8) * 8
    if parts == "color":
        planes, grad_background, dilated = grad_dense.prepass_and_planes(
            pixels, grad_pixels, aux, parts)
        return (tile_planes(planes, tile_h, tile_w, np_dma), grad_background,
                dilated)
    planes, dilated = plane_stack(pixels, grad_pixels, aux, tile_h, tile_w,
                                  np_dma, parts=parts,
                                  color_cotangent=color_cotangent)
    cot = grad_pixels if color_cotangent is None else color_cotangent
    covered_pre = aux.indices[..., 0] >= 0
    return planes, torch.where(covered_pre[..., None], 0.0, cot), dilated
