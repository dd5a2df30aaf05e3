"""Shared gradient-reduction math (from dirt_tpu/ops/grad_dense.py).

The per-face masked pixel reductions of the block-binned gradient, their
plane-stack layout, the plain pre-pass that builds the stack, and the
face-row -> vertex scatter.  The chunk-dense gradient kernel itself is not
on the main path (ROADMAP queue 2).

For face f with original index fid, and corner k:

    gx_k = sum over pixels with face_d == fid of bary_d_k * ax
    gy_k = sum ... of bary_d_k * ay
    gw_k = -sum ... of bary_d_k * (Px * cx + Py * cy),
           cx = (bary_d_0 x0 + bary_d_1 x1) + bary_d_2 x2  (cy alike)
    colour_kc = sum over pixels with face_pre == fid of bary_pre_k * grad_c

Padded face rows (fid -1) and padded pixels (all-zero planes) contribute
exact zeros: every product carries an ax/ay/Px/Py/bary_pre factor that the
pre-pass zeroes outside coverage.
"""

import torch

from . import backward


def plane_layout(parts, channels):
    """(n_planes, {plane name: index}) of the plane stack for `parts`:
        all:      ax ay Px Py bary_d0-2 face_d bary_pre0-2 face_pre grad..
        position: ax ay Px Py bary_d0-2 face_d                (8 planes)
        color:    bary_pre0-2 face_pre grad..                 (4+C planes)
    """
    if parts == "position":
        return 8, dict(ax=0, ay=1, px=2, py=3, bary_d=4, face_d=7)
    if parts == "color":
        return 4 + channels, dict(bary_pre=0, face_pre=3, grad=4)
    return 12 + channels, dict(ax=0, ay=1, px=2, py=3, bary_d=4, face_d=7,
                               bary_pre=8, face_pre=11, grad=12)


def d_out_for(parts, channels):
    """Per-face output width: per corner (gx, gy, gw) and/or `channels`
    colour rows, laid out [chunk, 3, d_corner]."""
    if parts == "position":
        return 9
    if parts == "color":
        return 3 * channels
    return 9 + 3 * channels


def _chunk_sums(col, plane, channels, parts="all"):
    """Masked per-face reductions for one chunk: [..., K, d_out].

    `col(i)` returns gradient-table column i as [..., K, 1]; `plane(i)`
    returns plane i as [..., 1, PIX] (plane_layout order)."""
    _, L = plane_layout(parts, channels)
    fid = col(4)
    want_pos = parts in ("all", "position")
    want_col = parts in ("all", "color")
    if want_pos:
        mask_d = plane(L["face_d"]) == fid
        bd = L["bary_d"]
        cx = ((plane(bd) * col(6) + plane(bd + 1) * col(7))
              + plane(bd + 2) * col(8))
        cy = ((plane(bd) * col(9) + plane(bd + 1) * col(10))
              + plane(bd + 2) * col(11))
        p = plane(L["px"]) * cx + plane(L["py"]) * cy
    if want_col:
        mask_pre = plane(L["face_pre"]) == fid

    def rsum(a):
        return a.sum(dim=-1, keepdim=True)

    sums = []
    for k in range(3):
        if want_pos:
            wd = torch.where(mask_d, plane(L["bary_d"] + k), 0.0)
            sums.append(rsum(wd * plane(L["ax"])))
            sums.append(rsum(wd * plane(L["ay"])))
            sums.append(-rsum(wd * p))
        if want_col:
            wp = torch.where(mask_pre, plane(L["bary_pre"] + k), 0.0)
            for c in range(channels):
                sums.append(rsum(wp * plane(L["grad"] + c)))
    return torch.cat(sums, dim=-1)


def prepass_and_planes(pixels, grad_pixels, aux, parts, color_cotangent=None):
    """The plain pre-pass for `parts` and its [B, NP, H, W] plane stack.
    Returns (planes, grad_background, dilated).

    parts="color" needs no Scharr or dilation (colour gradients read
    pre-dilation coverage).  `color_cotangent` (parts="all" only) takes the
    cotangent planes and the background gradient from it, while the
    position planes still come from pixels / grad_pixels.
    """
    f32 = lambda a: a.to(torch.float32)[:, None]
    chan = lambda a: a.movedim(-1, 1)
    covered_pre = aux.indices[..., 0] >= 0
    if parts == "color":
        grad_background = torch.where(covered_pre[..., None], 0.0,
                                      grad_pixels)
        bary_pre = torch.where(covered_pre[..., None], aux.barycentric, 0.0)
        planes = torch.cat([chan(bary_pre), f32(aux.face_index),
                            chan(grad_pixels)], dim=1)
        return planes, grad_background, torch.zeros_like(covered_pre)
    pre = backward.grad_prepass(pixels, grad_pixels, aux)
    position = [torch.stack([pre.ax, pre.ay, pre.px_t, pre.py_t], dim=1),
                chan(pre.bary_d), f32(pre.face_d)]
    if parts == "position":
        return torch.cat(position, dim=1), pre.grad_background, pre.dilated
    cot = grad_pixels if color_cotangent is None else color_cotangent
    grad_background = torch.where(covered_pre[..., None], 0.0, cot)
    planes = torch.cat(position + [chan(pre.bary_pre), f32(pre.face_pre),
                                   chan(cot)], dim=1)
    return planes, grad_background, pre.dilated


def scatter_face_grads(face_grads, seg, batch, num_vertices, channels,
                       parts):
    """Sums per-corner rows [..., 3, d_corner] into per-vertex
    (grad_vertices, grad_vertex_colors) by the flat vertex ids `seg`
    (batch-offset), zero-filling the parts not computed.  index_add_ is
    atomic on CUDA: its summation order varies from run to run."""
    d_corner = d_out_for(parts, channels) // 3
    rows = face_grads.reshape(-1, d_corner)
    summed = torch.zeros(batch * num_vertices, d_corner,
                         device=face_grads.device)
    summed.index_add_(0, seg.reshape(-1).long(), rows)
    summed = summed.reshape(batch, num_vertices, d_corner)
    zeros = torch.zeros(batch, num_vertices, device=face_grads.device)
    if parts == "color":
        return torch.zeros(batch, num_vertices, 4,
                           device=face_grads.device), summed
    grad_vertices = torch.stack(
        [summed[..., 0], summed[..., 1], zeros, summed[..., 2]], dim=-1)
    if parts == "position":
        return grad_vertices, torch.zeros(batch, num_vertices, channels,
                                          device=face_grads.device)
    return grad_vertices, summed[..., 3:]
