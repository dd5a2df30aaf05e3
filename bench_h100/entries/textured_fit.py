"""rasterise_batch_deferred of a UV-mapped mesh with a learnable texture,
as DIRT's samples/textured.py and the port's TexturedRenderer shade it: a
6-channel G-buffer (mask, u, v, normals) over a zero background, the
texture sampled bilinearly at each pixel's (u, v) with repeat addressing
(dirt_tpu_torch.utils.textures), double-sided diffuse light of colour 0.6
plus 0.4 of the texture under the mask, over the background colour (0,
0, 0.3).  The leaves beside the pose and the background are the texture
and the light's direction.

The normals are the port's lighting.vertex_normals of the vertices the
step rasterises, clip x, y and z: the mesh under an affine image of view
space, not its view-space normals.  It departs from physical shading in
that, and the reference (bench_h100.reference.texture) does the same.
"""

import torch

from bench_h100.reference import autograd, texture as plain
from dirt_tpu_torch import lighting
from dirt_tpu_torch.utils import textures

LIGHT = (0.3, -0.5, -0.8)
LEAVES = ("texture", "light")


def draw(config, num_vertices, generator, device):
    """The texture [h, w, C], uniform in [0, 1), a zero G-buffer background
    [B, H, W, gbuffer_channels] and the light."""
    size = config["texture"]
    return dict(
        texture=torch.rand((size["height"], size["width"], size["channels"]),
                           generator=generator, device=device),
        background=torch.zeros(config["batch"], config["height"],
                               config["width"], config["gbuffer_channels"],
                               device=device),
        light=torch.tensor(LIGHT, device=device))


def scene(clip, leaves, inputs):
    normals = lighting.vertex_normals(clip[..., :3], inputs.faces[0])
    uvs = inputs.mesh["uvs"].expand(clip.shape[0], -1, -1)
    return torch.cat([torch.ones_like(clip[..., :1]), uvs, normals],
                     -1).contiguous()


def rasterise(port, background, clip, values, faces, shade):
    return port.rasterise_batch_deferred(background, clip, values, faces,
                                         shade)


def shade(gbuffer, leaves):
    texture = leaves["texture"]
    mask, uvs, normals = gbuffer[..., :1], gbuffer[..., 1:3], gbuffer[..., 3:]
    base = textures.sample_texture(
        texture, textures.uvs_to_pixel_indices(uvs, texture.shape[:2]))
    diffuse = lighting.diffuse_directional(normals, base, leaves["light"],
                                           plain.LIGHT_COLOUR,
                                           double_sided=True)
    sky = torch.tensor(plain.SKY, device=gbuffer.device)
    return (diffuse + base * plain.AMBIENT) * mask + sky * (1. - mask)


def reference(clip, leaves, inputs):
    return autograd.rasterise_batch_deferred(
        leaves["background"], clip,
        plain.gbuffer_attributes(clip, inputs.mesh["uvs"], inputs.faces[0]),
        inputs.faces,
        lambda gbuffer: plain.shade(gbuffer, leaves["texture"],
                                    leaves["light"]))
