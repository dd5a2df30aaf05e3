"""Shared sweep math of the dense forward (from dirt_tpu/ops/forward_dense.py).

Only the math the block-binned schedule shares is ported: the pixel-centre
rows of a tile, the initial per-pixel state, one dense chunk sweep with its
lexicographic (depth, original index) winner pick in the COVER_FAST
coverage form, the GL_LESS merge, and the postprocess that un-tiles the
state and does the single division.  The "dense" backend's own kernels are
not on the main path (ROADMAP queue 2).

Packed per-pixel state rows (all float32; ints are exact below 2^24):
  [0:C]  interpolation numerators      [C:C+3]  E0, E1, E2 of the winner
  [C+3]  S_w of the winner             [C+4:C+7] winner vertex ids
  [C+7]  depth (running z-buffer)      [C+8]    original face index (-1 bg)
"""

import torch

from . import forward_pallas, reference

_BASE = forward_pallas._BASE


def pixel_ndc(tile_row, tile_col, height, width, tile_h, tile_w):
    """Pixel-centre NDC rows of flattened tiles, the expression of
    geometry.pixel_centre_ndc.  tile_row/tile_col are int tensors [...]
    (first pixel row/column of each tile); returns (xg, yg) [..., 1, PIX]."""
    p = torch.arange(tile_h * tile_w, dtype=torch.int32,
                     device=tile_row.device)
    rows = p // tile_w
    cols = p - rows * tile_w
    xg = ((tile_col[..., None] + cols).float() + 0.5) * (2.0 / width) - 1.0
    yg = 1.0 - ((tile_row[..., None] + rows).float() + 0.5) * (2.0 / height)
    return xg[..., None, :], yg[..., None, :]


def init_state(channels, pix, lead=(), device=None):
    """glClearDepth(1.0) equivalent: [*lead, C+9, PIX] with depth 1.0 and
    orig -1 (background); value rows are zero until a face wins."""
    state = torch.zeros(*lead, channels + 9, pix, device=device)
    state[..., channels + 7, :] = 1.0
    state[..., channels + 8, :] = -1.0
    return state


def _chunk_candidates(col, xg, yg, channels):
    """One dense chunk sweep in the COVER_FAST coverage form.

    `col(i)` returns face-table column i as [..., K, 1]; xg/yg are
    [..., 1, PIX].  Returns (cand [..., C+9, PIX], best_depth [..., 1, PIX],
    best_orig [..., 1, PIX]).  `covered` is bitwise the spec tree of
    geometry.fragment_cover_depth AND-ed with the valid flag (see the JAX
    module: the sign-branch union folds into per-edge equality with
    sp = s_w > 0, the clip becomes |s_z| <= |s_w|, and invalid rows die on
    their NaN z/w columns).
    """
    E0 = (col(0) * xg + col(1) * yg) + col(2)
    E1 = (col(3) * xg + col(4) * yg) + col(5)
    E2 = (col(6) * xg + col(7) * yg) + col(8)

    s_z = (E0 * col(9) + E1 * col(10)) + E2 * col(11)
    s_w = (E0 * col(12) + E1 * col(13)) + E2 * col(14)
    a0 = col(15) != 0.0
    a1 = col(16) != 0.0
    a2 = col(17) != 0.0
    sp = s_w > 0.0
    d0 = ((E0 > 0) | ((E0 == 0) & a0)) == sp
    d1 = ((E1 > 0) | ((E1 == 0) & a1)) == sp
    d2 = ((E2 > 0) | ((E2 == 0) & a2)) == sp
    covered = (d0 & d1 & d2) & (s_w != 0.0) & (s_z.abs() <= s_w.abs())
    depth = torch.where(covered, s_z / s_w, torch.inf)

    orig_col = col(19)
    best_depth = depth.amin(dim=-2, keepdim=True)
    at_best = depth == best_depth
    best_orig = torch.where(at_best, orig_col, float(forward_pallas._BIG)
                            ).amin(dim=-2, keepdim=True)
    winner = at_best & (orig_col == best_orig)

    def pick(plane):
        return torch.where(winner, plane, 0.0).sum(dim=-2, keepdim=True)

    # Numerators ((E0*a0 + E1*a1) + E2*a2): the expression of
    # geometry.interpolate_attributes, so constants stay exact.
    rows = [pick((E0 * col(_BASE + ch) + E1 * col(_BASE + channels + ch))
                 + E2 * col(_BASE + 2 * channels + ch))
            for ch in range(channels)]
    rows += [pick(E0), pick(E1), pick(E2), pick(s_w)]
    rows += [pick(col(24 + k)) for k in range(3)]
    rows += [best_depth, best_orig]
    return torch.cat(rows, dim=-2), best_depth, best_orig


def merge_state(prev, cand, best_depth, best_orig, ns):
    """GL_LESS + draw-order-tie merge of a chunk's winner into the running
    per-pixel state [..., NS, PIX]."""
    chunk_cov = best_depth < torch.inf
    prev_depth = prev[..., ns - 2:ns - 1, :]
    prev_orig = prev[..., ns - 1:ns, :]
    better = chunk_cov & (
        (best_depth < prev_depth)
        | ((best_depth == prev_depth) & (best_orig < prev_orig)))
    return torch.where(better, cand, prev)


def finalize(state, background, height, width, tiles_y, tiles_x,
             *, tile_h, tile_w):
    """Un-tiles the packed state [B, T, NS, PIX] and runs the postprocess:
    one division, composite, aux assembly.  Tiles past the image edge are
    cropped."""
    batch, _, _, channels = background.shape
    ns = channels + 9
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    state = state.reshape(batch, tiles_y, tiles_x, ns, tile_h, tile_w)
    state = state.permute(0, 1, 4, 2, 5, 3).reshape(batch, hp, wp, ns)
    state = state[:, :height, :width]

    num = state[..., :channels]
    e01 = state[..., channels:channels + 3]
    sw = state[..., channels + 3]
    vid = state[..., channels + 4:channels + 7]
    orig = state[..., channels + 8].to(torch.int32)

    covered = orig >= 0
    den = (e01[..., 0] + e01[..., 1]) + e01[..., 2]
    safe_den = torch.where(den == 0, 1.0, den)
    pixels = torch.where(covered[..., None], num / safe_den[..., None],
                         background)
    bary = torch.where(covered[..., None], e01 / safe_den[..., None], -1.0)
    clip_w = torch.where(covered, sw / safe_den, torch.inf)
    indices = torch.where(covered[..., None], vid.to(torch.int32), -1)
    aux = reference.RasterAux(face_index=orig, indices=indices,
                              barycentric=bary, clip_w=clip_w)
    return pixels, aux
