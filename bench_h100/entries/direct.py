"""rasterise_batch: the direct entry point, per-vertex colours rasterised
over a random background."""

import torch

from bench_h100.reference import autograd

LEAVES = ("colors",)


def draw(config, num_vertices, generator, device):
    """Colours [B, V, C], then the background [B, H, W, C], uniform."""
    uniform = lambda *shape: torch.rand(shape, generator=generator,
                                        device=device)
    batch, channels = config["batch"], config["channels"]
    return dict(colors=uniform(batch, num_vertices, channels),
                background=uniform(batch, config["height"], config["width"],
                                   channels))


def scene(clip, leaves, inputs):
    return leaves["colors"]


def rasterise(port, background, clip, values, faces, shade):
    return port.rasterise_batch(background, clip, values, faces)


def reference(clip, leaves, inputs):
    return autograd.rasterise_batch(leaves["background"], clip,
                                    leaves["colors"], inputs.faces)
