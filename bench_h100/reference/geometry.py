"""Triangle setup and fragment math, plain PyTorch.

Homogeneous edge functions e_i = cross(p_j, p_k) in (x, y, w) space,
E_i(q) = e_i . (x_ndc, y_ndc, 1), a top-left fill rule on E_i == 0
pixels, the per-fragment near/far clip |S_z| <= |S_w| with the sign
branch's S_w sign, and screen-linear depth S_z / S_w.  Every product is
its own eager operation, so it rounds before the subtraction (no FMA
contraction); never put torch.compile over these functions.
"""

from typing import NamedTuple

import torch


class FaceSetup(NamedTuple):
    """Per-face rasterisation constants, leading dims [*, F]."""
    e: torch.Tensor        # [*, F, 3, 3] edge coefficients (a, b, c)
    z: torch.Tensor        # [*, F, 3] clip-space z per corner
    w: torch.Tensor        # [*, F, 3] clip-space w per corner
    accept: torch.Tensor   # [*, F, 3] bool: include pixels with E_i == 0
    valid: torch.Tensor    # [*, F] bool: non-degenerate triangle


def pixel_centre_ndc(height, width, device=None):
    """NDC coordinates of pixel centres: (x_ndc [W], y_ndc [H])."""
    cols = torch.arange(width, dtype=torch.float32, device=device)
    rows = torch.arange(height, dtype=torch.float32, device=device)
    x_ndc = (cols + 0.5) * (2.0 / width) - 1.0
    y_ndc = 1.0 - (rows + 0.5) * (2.0 / height)
    return x_ndc, y_ndc


def gather_corners(values, faces):
    """values [B, V, D], faces [B, F, 3] -> corner rows [B, F, 3, D]."""
    batch = torch.arange(values.shape[0], device=values.device)
    return values[batch[:, None, None], faces.long()]


def _cross_xyw(u, v):
    ux, uy, uw = u[..., 0], u[..., 1], u[..., 2]
    vx, vy, vw = v[..., 0], v[..., 1], v[..., 2]
    t0, t1, t2 = uy * vw, uw * vy, uw * vx
    t3, t4, t5 = ux * vw, ux * vy, uy * vx
    return torch.stack([t0 - t1, t2 - t3, t4 - t5], dim=-1)


def face_setup(vertices, faces):
    """FaceSetup of clip-space vertices [B, V, 4] and faces [B, F, 3]."""
    corners = gather_corners(vertices.float(), faces)    # [B, F, 3, 4]
    p = corners[..., [0, 1, 3]]                          # (x, y, w)
    e0 = _cross_xyw(p[..., 1, :], p[..., 2, :])
    e1 = _cross_xyw(p[..., 2, :], p[..., 0, :])
    e2 = _cross_xyw(p[..., 0, :], p[..., 1, :])
    e = torch.stack([e0, e1, e2], dim=-2)                # [B, F, 3, 3]
    p0 = p[..., 0, :]
    d = ((p0[..., 0] * e0[..., 0] + p0[..., 1] * e0[..., 1])
         + p0[..., 2] * e0[..., 2])
    a, b = e[..., 0], e[..., 1]
    accept = (a > 0) | ((a == 0) & (b > 0))
    return FaceSetup(e=e, z=corners[..., 2], w=corners[..., 3],
                     accept=accept, valid=d != 0.0)


def edge_values(e, x_ndc, y_ndc):
    E0 = (e[..., 0, 0] * x_ndc + e[..., 0, 1] * y_ndc) + e[..., 0, 2]
    E1 = (e[..., 1, 0] * x_ndc + e[..., 1, 1] * y_ndc) + e[..., 1, 2]
    E2 = (e[..., 2, 0] * x_ndc + e[..., 2, 1] * y_ndc) + e[..., 2, 2]
    return E0, E1, E2


def fragment_cover_depth(e, z, w, accept, valid, x_ndc, y_ndc):
    """(covered bool, depth S_z / S_w where covered, +inf elsewhere) of
    faces broadcast against pixel grids."""
    E0, E1, E2 = edge_values(e, x_ndc, y_ndc)
    s_w = (E0 * w[..., 0] + E1 * w[..., 1]) + E2 * w[..., 2]
    s_z = (E0 * z[..., 0] + E1 * z[..., 1]) + E2 * z[..., 2]
    a0, a1, a2 = accept[..., 0], accept[..., 1], accept[..., 2]
    in_p = (((E0 > 0) | ((E0 == 0) & a0))
            & ((E1 > 0) | ((E1 == 0) & a1))
            & ((E2 > 0) | ((E2 == 0) & a2)))
    in_n = (((E0 < 0) | ((E0 == 0) & ~a0))
            & ((E1 < 0) | ((E1 == 0) & ~a1))
            & ((E2 < 0) | ((E2 == 0) & ~a2)))
    cov_p = in_p & (s_w > 0) & (s_z >= -s_w) & (s_z <= s_w)
    cov_n = in_n & (s_w < 0) & (s_z <= -s_w) & (s_z >= s_w)
    covered = (cov_p | cov_n) & valid
    # Divide raw, then select: covered pixels always have s_w != 0.
    return covered, torch.where(covered, s_z / s_w, torch.inf)


def fragment_barycentrics(e, x_ndc, y_ndc, w):
    """Perspective-correct barycentrics [..., 3] and the fragment clip w."""
    E0, E1, E2 = edge_values(e, x_ndc, y_ndc)
    s_e = (E0 + E1) + E2
    denom = torch.where(s_e == 0, 1.0, s_e)
    bary = torch.stack([E0 / denom, E1 / denom, E2 / denom], dim=-1)
    s_w = (E0 * w[..., 0] + E1 * w[..., 1]) + E2 * w[..., 2]
    return bary, s_w / denom


def interpolate_attributes(e, x_ndc, y_ndc, corner_attributes):
    """(sum_i E_i a_i) / (sum_i E_i) with one division; corner_attributes
    [..., 3, C] -> [..., C]."""
    E0, E1, E2 = edge_values(e, x_ndc, y_ndc)
    s_e = (E0 + E1) + E2
    num = ((E0[..., None] * corner_attributes[..., 0, :]
            + E1[..., None] * corner_attributes[..., 1, :])
           + E2[..., None] * corner_attributes[..., 2, :])
    denom = torch.where(s_e == 0, 1.0, s_e)
    return num / denom[..., None]
