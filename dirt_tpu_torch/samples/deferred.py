"""Deferred-shading sample: per-pixel Phong lighting from a G-buffer
(PyTorch port of samples/deferred.py).

Rasterises a 10-channel G-buffer (mask, world positions, albedo, normals)
and shades per pixel (ambient + diffuse + specular) in `shader_fn`; then
recovers the light direction from the shaded image through the deferred
shading gradients.

    python -m dirt_tpu_torch.samples.deferred [--out DIR] [--device cpu]
"""

import os

import torch

import dirt_tpu_torch
from .. import lighting
from ..devices import input_device
from .common import cube_scene, parse_args, save_ppm

WIDTH, HEIGHT = 640, 480
TRUE_LIGHT, START_LIGHT = (1., -0.3, -0.5), (0.3, -0.8, -0.2)
FIT_WIDTH, FIT_HEIGHT = 160, 120
STEPS, LEARNING_RATE = 20, 25.0


def make_shader(width, height):
    def shader_fn(gbuffer, view_matrix, light_direction):
        mask = gbuffer[:, :, :1]
        positions = gbuffer[:, :, 1:4]
        albedo = gbuffer[:, :, 4:7]
        normals = gbuffer[:, :, 7:]

        ambient = albedo * 0.2
        diffuse = lighting.diffuse_directional(
            normals.reshape(-1, 3), albedo.reshape(-1, 3),
            light_direction, light_color=(1., 0., 0.),
            double_sided=False).reshape(height, width, 3)
        camera_position = torch.linalg.inv(view_matrix)[3, :3]
        specular = lighting.specular_directional(
            positions.reshape(-1, 3), normals.reshape(-1, 3),
            albedo.reshape(-1, 3),
            light_direction, light_color=(1., 1., 1.),
            camera_position=camera_position,
            shininess=6., double_sided=False,
        ).reshape(height, width, 3)
        shaded = (diffuse + specular + ambient) * mask
        out = shaded + torch.tensor([0., 0., 0.3],
                                    device=gbuffer.device) * (1. - mask)
        # clip to [0, 1] as max-then-min (jnp.clip's tie gradients)
        return torch.minimum(torch.maximum(out, torch.zeros_like(out)),
                             torch.ones_like(out))
    return shader_fn


def render(light_direction, width=WIDTH, height=HEIGHT, device=None):
    device = input_device((light_direction,), device)
    light_direction = torch.as_tensor(light_direction, dtype=torch.float32,
                                      device=device)
    clip, faces, world, normals, view = cube_scene(
        [0., 0.5, 0.], width, height, device=device)
    attributes = torch.cat([
        torch.ones_like(world[:, :1]),   # coverage mask
        world[:, :3],                    # world positions
        torch.ones_like(normals),        # albedo
        normals,                         # normals
    ], dim=1)
    return dirt_tpu_torch.rasterise_deferred(
        background_attributes=torch.zeros(height, width, 10, device=device),
        vertices=clip, vertex_attributes=attributes, faces=faces,
        shader_fn=make_shader(width, height),
        shader_additional_inputs=[view, light_direction])


def unit(v):
    return v / torch.linalg.norm(v)


def fit(steps=STEPS, device=None, log=print):
    """Recovers the light direction by gradient descent on the mean squared
    image error; returns (the loss of every step, the unit light)."""
    device = input_device((), device)
    true_light = unit(torch.tensor(TRUE_LIGHT, device=device))
    target = render(true_light, FIT_WIDTH, FIT_HEIGHT).detach()
    light = torch.tensor(START_LIGHT, device=device)
    losses = []
    for step in range(steps):
        leaf = light.clone().requires_grad_(True)
        loss = torch.mean((render(unit(leaf), FIT_WIDTH, FIT_HEIGHT)
                           - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        light = light - LEARNING_RATE * leaf.grad
        if step % 5 == 0:
            log(f'step {step:2d} loss {losses[-1]:.6f}')
    log(f'recovered light: {unit(light).tolist()}')
    log(f'true light:      {true_light.tolist()}')
    return losses, unit(light)


def main():
    args = parse_args(__doc__.splitlines()[0])
    with torch.no_grad():
        image = render(unit(torch.tensor(TRUE_LIGHT)).numpy(),
                       device=args.device)
    save_ppm(os.path.join(args.out, 'deferred.ppm'), image)
    fit(device=args.device)


if __name__ == '__main__':
    main()
