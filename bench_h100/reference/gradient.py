"""The plain scatter gradient, plain PyTorch: filter-based derivatives
with occluder dilation (the semantics of DIRT's rasterise_grad_egl.cu).

  1. 3x3 Scharr filtering of the rendered pixels (weights 3/32 and 10/32,
     negative-offset minus positive-offset, edge-clamped reads);
  2. colour gradients: the bary-weighted cotangent scattered to the
     covering triangle's vertices, or passed through to the background;
  3. occlusion-boundary dilation: interior pixels look along the dominant
     Scharr axis (sign dithered by pixel parity), then the opposite way,
     and adopt a neighbour lying over a different, nearer triangle;
  4. position gradients through the viewport transform, scattered into
     the vertices' x, y and w (never z).

Scatter sums accumulate in float64 and round once.
"""

import torch


def _sum_last(x):
    """Sum over the last axis, left to right."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _shift(array, ox, oy, fill):
    """a[:, r - oy, c + ox] of array [B, H, W, ...], `fill` out of bounds."""
    h, w = array.shape[1], array.shape[2]
    pad = [0, 0] * (array.dim() - 3) + [1, 1, 1, 1]
    padded = torch.nn.functional.pad(array, pad, value=fill)
    return padded[:, 1 - oy:1 - oy + h, 1 + ox:1 + ox + w]


def _shift_clamped(array, ox, oy):
    h, w = array.shape[1], array.shape[2]
    rows = (torch.arange(h, device=array.device) - oy).clamp(0, h - 1)
    cols = (torch.arange(w, device=array.device) + ox).clamp(0, w - 1)
    return array[:, rows][:, :, cols]


def scharr_filters(pixels):
    at = lambda ox, oy: _shift_clamped(pixels, ox, oy)
    scharr_x = ((at(-1, -1) + at(-1, +1) - at(+1, -1) - at(+1, +1)) * (3. / 32.)
                + (at(-1, 0) - at(+1, 0)) * (10. / 32.))
    scharr_y = ((at(-1, -1) + at(+1, -1) - at(-1, +1) - at(+1, +1)) * (3. / 32.)
                + (at(0, -1) - at(0, +1)) * (10. / 32.))
    return scharr_x, scharr_y


def dilate(indices, barycentric, clip_w, scharr_x, scharr_y):
    """The two axial dilation attempts; returns post-dilation (indices,
    barycentric, clip_w)."""
    _, h, w = clip_w.shape
    device = clip_w.device
    horizontal = _sum_last(scharr_x.abs()) > _sum_last(scharr_y.abs())
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    flip = (rows + cols) % 2 == 1
    # Offsets 0:(+1,0) 1:(-1,0) 2:(0,+1) 3:(0,-1)
    primary = torch.where(horizontal, torch.where(flip, 1, 0),
                          torch.where(flip, 3, 2))
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    offs = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    n_idx = [_shift(indices, ox, oy, -1) for ox, oy in offs]
    n_bary = [_shift(barycentric, ox, oy, -1.0) for ox, oy in offs]
    n_w = [_shift(clip_w, ox, oy, torch.inf) for ox, oy in offs]

    def attempt(choice, idx_cur, bary_cur, w_cur, already):
        def sel(stack):
            c = choice[..., None] if stack[0].dim() == 4 else choice
            out = stack[0]
            for k in range(1, len(offs)):
                out = torch.where(c == k, stack[k], out)
            return out
        cand_idx, cand_bary, cand_w = sel(n_idx), sel(n_bary), sel(n_w)
        # Over a triangle, a different triangle, and nearer (exact).
        cond = (interior & ~already & (cand_idx[..., 0] != -1)
                & (cand_idx != idx_cur).any(dim=-1) & (w_cur > cand_w))
        return (torch.where(cond[..., None], cand_idx, idx_cur),
                torch.where(cond[..., None], cand_bary, bary_cur),
                torch.where(cond, cand_w, w_cur), already | cond)

    idx1, bary1, w1, done = attempt(primary, indices, barycentric, clip_w,
                                    torch.zeros_like(clip_w,
                                                     dtype=torch.bool))
    idx2, bary2, w2, _ = attempt(primary ^ 1, idx1, bary1, w1, done)
    return idx2, bary2, w2


def _segment_sum(rows, segments, num_segments):
    out = torch.zeros(num_segments, rows.shape[-1], dtype=torch.float64,
                      device=rows.device)
    return out.index_add_(0, segments.reshape(-1).long(),
                          rows.double()).float()


def grad(vertices, pixels, grad_pixels, aux, color_cotangent=None):
    """(grad_background, grad_vertices [B, V, 4], grad_vertex_colors) of
    one channel group; `color_cotangent` (default grad_pixels) feeds the
    colour and background rows, the pixels' Scharr the positions."""
    batch, h, w, _ = pixels.shape
    num_vertices = vertices.shape[1]
    color_cot = grad_pixels if color_cotangent is None else color_cotangent
    channels = color_cot.shape[-1]
    indices, barycentric, clip_w = aux.indices, aux.barycentric, aux.clip_w
    covered = indices[..., 0] >= 0
    boff = (torch.arange(batch, device=pixels.device)
            * num_vertices)[:, None, None, None]

    contrib = color_cot[..., None, :] * barycentric[..., :, None]
    contrib = torch.where(covered[..., None, None], contrib, 0.0)
    targets = torch.where(covered[..., None], indices, 0) + boff
    grad_colors = _segment_sum(contrib.reshape(-1, channels), targets,
                               batch * num_vertices).reshape(
                                   batch, num_vertices, channels)
    grad_background = torch.where(covered[..., None], 0.0, color_cot)

    scharr_x, scharr_y = scharr_filters(pixels)
    indices_d, bary_d, clip_w_d = dilate(indices, barycentric, clip_w,
                                         scharr_x, scharr_y)
    covered_d = indices_d[..., 0] >= 0
    dl_dx = _sum_last(grad_pixels * scharr_x)
    dl_dy = _sum_last(grad_pixels * scharr_y)
    safe_idx = torch.where(covered_d[..., None], indices_d, 0)
    b = torch.arange(batch, device=pixels.device)[:, None, None, None]
    corner_xy = vertices[b, safe_idx.long(), :2]          # [B, H, W, 3, 2]
    clip_x = _sum_last(bary_d * corner_xy[..., 0])
    clip_y = _sum_last(bary_d * corner_xy[..., 1])
    safe_w = torch.where(covered_d, clip_w_d, 1.0)
    dl_dx_vert = dl_dx[..., None] * bary_d
    dl_dy_vert = dl_dy[..., None] * bary_d
    gx = dl_dx_vert * ((.5 * w) / safe_w)[..., None]
    gy = dl_dy_vert * ((.5 * h) / safe_w)[..., None]
    gw = (dl_dx_vert * (-.5 * w * clip_x / (safe_w * safe_w))[..., None]
          + dl_dy_vert * (-.5 * h * clip_y / (safe_w * safe_w))[..., None])
    pos = torch.stack([gx, gy, torch.zeros_like(gx), gw], dim=-1)
    pos = torch.where(covered_d[..., None, None], pos, 0.0)
    grad_vertices = _segment_sum(pos.reshape(-1, 4), safe_idx + boff,
                                 batch * num_vertices).reshape(
                                     batch, num_vertices, 4)
    return grad_background, grad_vertices, grad_colors


def channel_groups(channels):
    """DIRT's 3+1 channel grouping as (begin, end) slices."""
    if channels in (1, 3):
        return [(0, channels)]
    groups, begin = [], 0
    while begin < channels:
        end = begin + 3 if begin + 3 <= channels else begin + 1
        groups.append((begin, end))
        begin = end
    return groups


def grad_grouped(vertices, pixels, grad_pixels, aux, color_cotangent=None):
    """Per channel group: Scharr and dilation per group, the vertex
    gradients summed; colour and background rows from one call with the
    whole colour cotangent (default grad_pixels)."""
    color_cot = grad_pixels if color_cotangent is None else color_cotangent
    grad_background = grad_colors = grad_vertices = None
    for i, (begin, end) in enumerate(channel_groups(pixels.shape[-1])):
        bg, gv, gc = grad(vertices, pixels[..., begin:end],
                          grad_pixels[..., begin:end], aux, color_cot)
        if i == 0:
            grad_background, grad_colors = bg, gc
        grad_vertices = gv if grad_vertices is None else grad_vertices + gv
    return grad_background, grad_vertices, grad_colors
