"""Analytic gradient assembly: filter-based derivatives with occluder
dilation (PyTorch port of dirt_tpu/ops/backward.py).

The semantics are the reference gradient kernel's
(csrc/rasterise_grad_egl.cu:93-236), as dirt_tpu implements them:

  1. 3x3 Scharr filtering of the rendered pixels (weights 3/32 and 10/32,
     negative-offset minus positive-offset, edge-clamped reads);
  2. colour gradients: the bary-weighted cotangent scattered to the
     covering triangle's vertices (pre-dilation), or passed through to the
     background;
  3. occlusion-boundary dilation: interior pixels look along the dominant
     Scharr axis (sign dithered by pixel parity), then the opposite way,
     and adopt a neighbour lying over a different, nearer triangle;
  4. position gradients through the viewport transform, scattered into the
     vertices' x, y and w (never z).

This module is the plain "xla" path (jax.ops.segment_sum becomes
index_add_) and the channel grouping; the block-binned path with its CUDA
kernels is ops/grad_blocks.py.  The opt-in diagonal dilation and the
deferred entry point are not ported yet (ROADMAP).
"""

from typing import NamedTuple

import torch

IMPLEMENTATIONS = ("xla", "blocks")


class RasteriseGrads(NamedTuple):
    grad_background: torch.Tensor     # [B, H, W, C]
    grad_vertices: torch.Tensor       # [B, V, 4]
    grad_vertex_colors: torch.Tensor  # [B, V, C]
    debug: torch.Tensor               # [B, H, W, 3] (see debug_image)


def debug_image(dilated, grad_pixels):
    """The reference grad op's `debug_thingy`: channel 0 marks dilated
    pixels (1e-2), channels 1 and 2 echo the cotangent's channels 1 and 2
    (zero when it has fewer).  dilated [*, H, W] bool, grad_pixels
    [*, H, W, C] -> [*, H, W, 3]."""
    marker = torch.where(dilated, 1.e-2, 0.0)
    channels = grad_pixels.shape[-1]
    ch1 = grad_pixels[..., 1] if channels > 1 else torch.zeros_like(marker)
    ch2 = grad_pixels[..., 2] if channels > 2 else torch.zeros_like(marker)
    return torch.stack([marker, ch1, ch2], dim=-1)


def _sum_last(x):
    """Sum over the last axis, strictly left to right (so the CUDA
    pre-pass, which accumulates channel by channel, matches it bitwise)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _shift(array, ox, oy, fill):
    """array [B, H, W, ...]; returns a[:, r - oy, c + ox] with `fill` out
    of bounds (the reference's `at(ox, oy)` convention)."""
    h, w = array.shape[1], array.shape[2]
    pad = [0, 0] * (array.dim() - 3) + [1, 1, 1, 1]
    padded = torch.nn.functional.pad(array, pad, value=fill)
    return padded[:, 1 - oy:1 - oy + h, 1 + ox:1 + ox + w]


def _shift_clamped(array, ox, oy):
    """Like _shift but edge-clamped (Scharr's out-of-bounds reads)."""
    h, w = array.shape[1], array.shape[2]
    rows = (torch.arange(h, device=array.device) - oy).clamp(0, h - 1)
    cols = (torch.arange(w, device=array.device) + ox).clamp(0, w - 1)
    return array[:, rows][:, :, cols]


def scharr_filters(pixels):
    """3x3 Scharr responses of [B, H, W, C] pixels (negative-offset minus
    positive-offset, rasterise_grad_egl.cu:125-127)."""
    at = lambda ox, oy: _shift_clamped(pixels, ox, oy)
    scharr_x = ((at(-1, -1) + at(-1, +1) - at(+1, -1) - at(+1, +1)) * (3. / 32.)
                + (at(-1, 0) - at(+1, 0)) * (10. / 32.))
    scharr_y = ((at(-1, -1) + at(+1, -1) - at(-1, +1) - at(+1, +1)) * (3. / 32.)
                + (at(0, -1) - at(0, +1)) * (10. / 32.))
    return scharr_x, scharr_y


def _dilate(indices, barycentric, clip_w, scharr_x, scharr_y, face_index):
    """Occlusion-boundary dilation (rasterise_grad_egl.cu:153-194), the
    reference's two axial attempts.  Batched [B, H, W, ...] arguments.
    Returns post-dilation (indices, barycentric, clip_w, dilated,
    face_index)."""
    _, h, w = clip_w.shape
    device = clip_w.device
    l1_x = _sum_last(scharr_x.abs())
    l1_y = _sum_last(scharr_y.abs())
    horizontal = l1_x > l1_y
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    flip = (rows + cols) % 2 == 1
    # Offset choice: 0:(+1,0) 1:(-1,0) 2:(0,+1) 3:(0,-1)
    primary = torch.where(horizontal, torch.where(flip, 1, 0),
                          torch.where(flip, 3, 2))
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)

    offs = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    n_idx = [_shift(indices, ox, oy, -1) for ox, oy in offs]
    n_bary = [_shift(barycentric, ox, oy, -1.0) for ox, oy in offs]
    n_w = [_shift(clip_w, ox, oy, torch.inf) for ox, oy in offs]
    n_face = [_shift(face_index, ox, oy, -1) for ox, oy in offs]

    def attempt(choice, idx_cur, bary_cur, w_cur, face_cur, already):
        def sel(stack):
            c = choice[..., None] if stack[0].dim() == 4 else choice
            out = stack[0]
            for k in range(1, len(offs)):
                out = torch.where(c == k, stack[k], out)
            return out
        cand_idx, cand_bary = sel(n_idx), sel(n_bary)
        cand_w, cand_face = sel(n_w), sel(n_face)
        # Over a triangle, a different triangle, and nearer (exact compares).
        cond = (interior & ~already
                & (cand_idx[..., 0] != -1)
                & (cand_idx != idx_cur).any(dim=-1)
                & (w_cur > cand_w))
        return (torch.where(cond[..., None], cand_idx, idx_cur),
                torch.where(cond[..., None], cand_bary, bary_cur),
                torch.where(cond, cand_w, w_cur),
                torch.where(cond, cand_face, face_cur),
                already | cond)

    idx1, bary1, w1, face1, dilated = attempt(
        primary, indices, barycentric, clip_w, face_index,
        torch.zeros_like(clip_w, dtype=torch.bool))
    idx2, bary2, w2, face2, dilated = attempt(
        primary ^ 1, idx1, bary1, w1, face1, dilated)
    return idx2, bary2, w2, dilated, face2


class GradPrepass(NamedTuple):
    """Face-independent per-pixel planes of the block-binned gradient (all
    [B, H, W] unless noted)."""
    grad_background: torch.Tensor   # [B, H, W, C]
    covered_pre: torch.Tensor       # bool, pre-dilation coverage
    face_pre: torch.Tensor          # int32 pre-dilation face index
    bary_pre: torch.Tensor          # [B, H, W, 3] (zeroed outside)
    face_d: torch.Tensor            # int32 post-dilation face index
    bary_d: torch.Tensor            # [B, H, W, 3] post-dilation
    ax: torch.Tensor                # dl_dx * (W/2) / clip_w   (0 off-coverage)
    ay: torch.Tensor                # dl_dy * (H/2) / clip_w
    px_t: torch.Tensor              # dl_dx * (W/2) / clip_w^2
    py_t: torch.Tensor              # dl_dy * (H/2) / clip_w^2
    dilated: torch.Tensor           # bool dilation marker (debug)


def grad_prepass(pixels, grad_pixels, aux):
    """Scharr filtering, occluder dilation and the face-independent
    viewport factors (rasterise_grad_egl.cu:113-194,203-208), batched."""
    _, height, width, _ = pixels.shape
    scharr_x, scharr_y = scharr_filters(pixels)
    covered_pre = aux.indices[..., 0] >= 0
    grad_background = torch.where(covered_pre[..., None], 0.0, grad_pixels)
    _, bary_d, clip_w_d, dilated, face_d = _dilate(
        aux.indices, aux.barycentric, aux.clip_w, scharr_x, scharr_y,
        aux.face_index)
    covered_d = face_d >= 0

    dl_dx = _sum_last(grad_pixels * scharr_x)
    dl_dy = _sum_last(grad_pixels * scharr_y)
    safe_w = torch.where(covered_d, clip_w_d, 1.0)
    half_w, half_h = 0.5 * width, 0.5 * height
    ax = torch.where(covered_d, dl_dx * half_w / safe_w, 0.0)
    ay = torch.where(covered_d, dl_dy * half_h / safe_w, 0.0)
    px_t = torch.where(covered_d, dl_dx * half_w / (safe_w * safe_w), 0.0)
    py_t = torch.where(covered_d, dl_dy * half_h / (safe_w * safe_w), 0.0)
    return GradPrepass(
        grad_background=grad_background,
        covered_pre=covered_pre,
        face_pre=aux.face_index,
        bary_pre=torch.where(covered_pre[..., None], aux.barycentric, 0.0),
        face_d=face_d, bary_d=bary_d,
        ax=ax, ay=ay, px_t=px_t, py_t=py_t,
        dilated=dilated)


def _segment_sum(rows, segments, num_segments):
    out = torch.zeros(num_segments, rows.shape[-1], device=rows.device)
    return out.index_add_(0, segments.reshape(-1).long(), rows)


def rasterise_grad_xla(vertices, pixels, grad_pixels, aux, parts="all",
                       color_cotangent=None):
    """The plain scatter gradient ("xla" in dirt_tpu) for a batch: the
    semantics of dirt_tpu's rasterise_grad_single, with every [B, ...]
    image at once and index_add_ for segment_sum.  `parts` and
    `color_cotangent` follow rasterise_grad_batch."""
    batch, h, w, _ = pixels.shape
    num_vertices = vertices.shape[1]
    color_cot = grad_pixels if color_cotangent is None else color_cotangent
    color_channels = color_cot.shape[-1]
    indices, barycentric, clip_w = aux.indices, aux.barycentric, aux.clip_w
    covered = indices[..., 0] >= 0
    boff = (torch.arange(batch, device=pixels.device)
            * num_vertices)[:, None, None, None]

    if parts in ("all", "color"):
        contrib = color_cot[..., None, :] * barycentric[..., :, None]
        contrib = torch.where(covered[..., None, None], contrib, 0.0)
        targets = torch.where(covered[..., None], indices, 0) + boff
        grad_vertex_colors = _segment_sum(
            contrib.reshape(-1, color_channels), targets,
            batch * num_vertices).reshape(batch, num_vertices, color_channels)
    else:
        grad_vertex_colors = torch.zeros(batch, num_vertices, color_channels,
                                         device=pixels.device)
    grad_background = torch.where(covered[..., None], 0.0, color_cot)
    if parts == "color":
        return RasteriseGrads(
            grad_background,
            torch.zeros(batch, num_vertices, 4, device=pixels.device),
            grad_vertex_colors,
            debug_image(torch.zeros_like(covered), grad_pixels))

    scharr_x, scharr_y = scharr_filters(pixels)
    indices_d, bary_d, clip_w_d, dilated, _ = _dilate(
        indices, barycentric, clip_w, scharr_x, scharr_y, aux.face_index)
    covered_d = indices_d[..., 0] >= 0
    dl_dx = _sum_last(grad_pixels * scharr_x)
    dl_dy = _sum_last(grad_pixels * scharr_y)

    safe_idx = torch.where(covered_d[..., None], indices_d, 0)
    b = torch.arange(batch, device=pixels.device)[:, None, None, None]
    corner_xy = vertices[b, safe_idx.long(), :2]          # [B, H, W, 3, 2]
    clip_x = _sum_last(bary_d * corner_xy[..., 0])
    clip_y = _sum_last(bary_d * corner_xy[..., 1])
    safe_w = torch.where(covered_d, clip_w_d, 1.0)
    d_xview_by_xclip = (.5 * w) / safe_w
    d_yview_by_yclip = (.5 * h) / safe_w
    d_xview_by_wclip = -.5 * w * clip_x / (safe_w * safe_w)
    d_yview_by_wclip = -.5 * h * clip_y / (safe_w * safe_w)

    dl_dx_vert = dl_dx[..., None] * bary_d
    dl_dy_vert = dl_dy[..., None] * bary_d
    gx = dl_dx_vert * d_xview_by_xclip[..., None]
    gy = dl_dy_vert * d_yview_by_yclip[..., None]
    gw = (dl_dx_vert * d_xview_by_wclip[..., None]
          + dl_dy_vert * d_yview_by_wclip[..., None])
    pos = torch.stack([gx, gy, torch.zeros_like(gx), gw], dim=-1)
    pos = torch.where(covered_d[..., None, None], pos, 0.0)
    grad_vertices = _segment_sum(
        pos.reshape(-1, 4), safe_idx + boff,
        batch * num_vertices).reshape(batch, num_vertices, 4)
    return RasteriseGrads(grad_background, grad_vertices, grad_vertex_colors,
                          debug_image(dilated, grad_pixels))


def default_implementation(device):
    """"blocks" (the CUDA kernels) for CUDA tensors, "xla" on the CPU --
    dirt_tpu's defaults on its accelerator and on the CPU."""
    return "blocks" if torch.device(device).type == "cuda" else "xla"


def rasterise_grad_batch(vertices, faces, pixels, grad_pixels, aux,
                         implementation=None, parts="all",
                         color_cotangent=None):
    """Batched gradient assembly ([B, ...] on every argument).

    `parts` ("all" / "position" / "color") selects which gradient rows are
    computed; skipped outputs are zeros and computed ones equal the
    matching parts="all" rows.  `color_cotangent` ([B, H, W, C'],
    parts="all" only) feeds the colour and background gradients while the
    position gradients keep Scharr-filtering `pixels` against
    `grad_pixels`.  `implementation`: "xla" (this module) or "blocks"
    (ops/grad_blocks.py); None chooses by device.
    """
    if color_cotangent is not None and parts != "all":
        raise ValueError("color_cotangent requires parts='all' (it IS the "
                         "fused position+color form)")
    if parts not in ("all", "position", "color"):
        raise ValueError(
            f"unknown parts {parts!r}; expected 'all', 'position' or 'color'")
    implementation = implementation or default_implementation(pixels.device)
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"unknown gradient implementation "
                         f"{implementation!r}; expected one of "
                         f"{IMPLEMENTATIONS} or None")
    vertices = vertices.float().contiguous()
    pixels = pixels.float().contiguous()
    grad_pixels = grad_pixels.float().contiguous()
    if color_cotangent is not None:
        color_cotangent = color_cotangent.float().contiguous()
    if implementation == "blocks":
        from . import grad_blocks
        return grad_blocks.rasterise_grad_batch(
            vertices, faces, pixels, grad_pixels, aux, parts=parts,
            color_cotangent=color_cotangent)
    return rasterise_grad_xla(vertices, pixels, grad_pixels, aux, parts,
                              color_cotangent)


def _channel_groups(channels):
    """The reference's 3+1 channel grouping (dirt/rasterise_ops.py:86-108)
    as (begin, end) slices; [(0, channels)] for the native 1/3 cases."""
    if channels in (1, 3):
        return [(0, channels)]
    groups = []
    begin = 0
    while begin < channels:
        end = begin + 3 if begin + 3 <= channels else begin + 1
        groups.append((begin, end))
        begin = end
    return groups


def rasterise_grad_grouped(vertices, faces, pixels, grad_pixels, aux,
                           parts="all", implementation=None):
    """Channel-grouped gradient assembly, matching the reference.

    Scharr responses and dilation decisions are per channel GROUP, so the
    per-group vertex gradients are computed separately and summed; colour
    and background rows are per-channel independent and ride ONE call
    (group 0's, via `color_cotangent`).  Returns (grad_background,
    grad_vertices, grad_vertex_colors), batched.
    """
    channels = pixels.shape[-1]
    if channels in (1, 3) or parts == "color":
        grads = rasterise_grad_batch(vertices, faces, pixels, grad_pixels,
                                     aux, parts=parts,
                                     implementation=implementation)
        return (grads.grad_background, grads.grad_vertices,
                grads.grad_vertex_colors)

    grad_background = None
    grad_vertex_colors = None
    grad_vertices = None
    position_backgrounds = []
    for begin, end in _channel_groups(channels):
        if parts == "all" and grad_vertices is None:
            grads = rasterise_grad_batch(
                vertices, faces, pixels[..., begin:end],
                grad_pixels[..., begin:end], aux, parts="all",
                implementation=implementation, color_cotangent=grad_pixels)
            grad_background = grads.grad_background
            grad_vertex_colors = grads.grad_vertex_colors
        else:
            grads = rasterise_grad_batch(
                vertices, faces, pixels[..., begin:end],
                grad_pixels[..., begin:end], aux, parts="position",
                implementation=implementation)
            position_backgrounds.append(grads.grad_background)
        grad_vertices = (grads.grad_vertices if grad_vertices is None
                         else grad_vertices + grads.grad_vertices)
    if parts == "position":
        grad_background = torch.cat(position_backgrounds, dim=-1)
        grad_vertex_colors = torch.zeros(
            grad_vertices.shape[:-1] + (channels,), device=pixels.device)
    return grad_background, grad_vertices, grad_vertex_colors
