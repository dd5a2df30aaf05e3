"""The textured deferred step's scene and shader, plain PyTorch: vertex
normals, the UV repeat mapping, a bilinear texture sampler and
double-sided Lambert under one light.

Independent of the port: the sampler reads the texture by advanced
indexing, texture[r, c], whose backward is index_put_(accumulate=True),
and the normals are written out as cross products summed by
index_put_(accumulate=True).  The semantics are the port's
(dirt_tpu_torch.utils.textures, .lighting): repeat addressing, corners
clamped to the texture, face normals made unit before they are summed
(not weighted by area), |x| with gradient 1 at 0.
"""

import torch

AMBIENT = 0.4
LIGHT_COLOUR = (0.6, 0.6, 0.6)
SKY = (0., 0., 0.3)


def vertex_normals(vertices, faces):
    """[B, V, 3] unit vertex normals of vertices [B, V, 3] on faces [F, 3]:
    each vertex the renormalised sum of its faces' unit normals."""
    faces = faces.long()
    p0, p1, p2 = (vertices[:, faces[:, k]] for k in range(3))
    a, b = p1 - p0, p2 - p0
    cross = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)
    unit = cross / (torch.sqrt((cross * cross).sum(-1, keepdim=True))
                    + 1.e-12)
    batch = torch.arange(vertices.shape[0], device=vertices.device)[:, None]
    summed = torch.zeros_like(vertices).index_put(
        (batch, faces.reshape(-1)[None, :]),
        unit.repeat_interleave(3, dim=1), accumulate=True)
    return summed / (torch.sqrt((summed * summed).sum(-1, keepdim=True))
                     + 1.e-12)


def gbuffer_attributes(clip, uvs, faces):
    """The 6 vertex attributes [B, V, 6]: mask 1, (u, v), and the unit
    normals of the mesh under the clip-space map (clip x, y, z)."""
    batch = clip.shape[0]
    return torch.cat([torch.ones_like(clip[..., :1]),
                      uvs.expand(batch, -1, -1),
                      vertex_normals(clip[..., :3], faces)], -1).contiguous()


def repeat_indices(uvs, height, width):
    """(row, col) texel indices of (u, v): v and u wrapped to [0, 1), times
    the texture's height and width."""
    size = torch.tensor([height, width], dtype=torch.float32,
                        device=uvs.device)
    return uvs.flip(-1) % 1. * size


def sample_bilinear(texture, indices):
    """texture [h, w, C] at indices [..., 2]: the four corners (floor, and
    floor + 1, clamped to the texture) blended by the fractions."""
    h, w = texture.shape[0], texture.shape[1]
    floor = torch.floor(indices)
    frac = indices - floor
    zero = torch.zeros((), dtype=torch.int64, device=indices.device)
    clamp = lambda x, top: torch.minimum(torch.maximum(x, zero), top + zero)
    r0, c0 = clamp(floor[..., 0].long(), h - 1), clamp(floor[..., 1].long(),
                                                       w - 1)
    r1, c1 = clamp(r0 + 1, h - 1), clamp(c0 + 1, w - 1)
    fr, fc = frac[..., :1], frac[..., 1:]
    return (texture[r0, c0] * (1. - fc) * (1. - fr)
            + texture[r0, c1] * fc * (1. - fr)
            + texture[r1, c0] * (1. - fc) * fr
            + texture[r1, c1] * fc * fr)


def shade(gbuffer, texture, light):
    """The shaded pixels [B, H, W, 3] of the G-buffer (mask, u, v,
    normals): the texture sampled at (u, v), lit by double-sided Lambert
    (|n . -light| x LIGHT_COLOUR) plus AMBIENT, under the mask, over SKY."""
    mask, uvs, normals = gbuffer[..., :1], gbuffer[..., 1:3], gbuffer[..., 3:]
    base = sample_bilinear(texture, repeat_indices(uvs, texture.shape[0],
                                                   texture.shape[1]))
    cosine = (normals * -light).sum(-1, keepdim=True)
    cosine = torch.where(cosine >= 0, cosine, -cosine)
    colour = torch.tensor(LIGHT_COLOUR, device=gbuffer.device)
    sky = torch.tensor(SKY, device=gbuffer.device)
    return (colour * base * cosine + base * AMBIENT) * mask + sky * (1. - mask)
