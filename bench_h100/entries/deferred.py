"""rasterise_batch_deferred: a 10-channel G-buffer (mask, clip xyz,
albedo, unit normals) over a zero background, shaded by ambient +
Lambert under one light (reference.scene.shader)."""

import torch

from bench_h100.reference import autograd, scene as plain

LIGHT = (0.3, -0.5, -0.8)
GBUFFER_CHANNELS = 10   # mask, clip xyz, albedo, unit normals
LEAVES = ("albedo", "normals", "light")


def draw(config, num_vertices, generator, device):
    """Normals (standard normal, then made unit), albedo in [0.2, 1), a
    zero G-buffer background and the light."""
    batch = config["batch"]
    uniform = lambda *shape: torch.rand(shape, generator=generator,
                                        device=device)
    normals = torch.randn(batch, num_vertices, 3, generator=generator,
                          device=device)
    return dict(
        albedo=0.2 + 0.8 * uniform(batch, num_vertices, 3),
        normals=normals / torch.linalg.norm(normals, dim=-1, keepdim=True),
        background=torch.zeros(batch, config["height"], config["width"],
                               GBUFFER_CHANNELS, device=device),
        light=torch.tensor(LIGHT, device=device))


def scene(clip, leaves, inputs):
    return plain.gbuffer_attributes(clip, leaves["albedo"],
                                    leaves["normals"])


def rasterise(port, background, clip, values, faces, shade):
    return port.rasterise_batch_deferred(background, clip, values, faces,
                                         shade)


def shade(gbuffer, leaves):
    return plain.shader(gbuffer, leaves["light"])


def reference(clip, leaves, inputs):
    return autograd.rasterise_batch_deferred(
        leaves["background"], clip, scene(clip, leaves, inputs),
        inputs.faces, lambda gbuffer: shade(gbuffer, leaves))
