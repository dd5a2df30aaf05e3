"""Direct (Gouraud) shading sample, plus a taste of inverse rendering
(PyTorch port of samples/simple.py).

The canonical end-to-end pipeline: object -> world -> normals -> camera ->
clip -> per-vertex diffuse -> rasterise.  After rendering the image it
runs a short gradient-descent loop recovering the cube's rotation from
the image.

    python -m dirt_tpu_torch.samples.simple [--out DIR] [--device cpu]
"""

import os

import torch

import dirt_tpu_torch
from .. import lighting
from ..devices import input_device
from .common import cube_scene, parse_args, save_ppm

WIDTH, HEIGHT = 640, 480
LIGHT_DIRECTION = (1., 0., 0.)
# The fit: the yaw angle from the image, at a smaller resolution.
FIT_WIDTH, FIT_HEIGHT = 160, 120
TARGET_ANGLE, START_ANGLE = 0.5, 0.25
STEPS, LEARNING_RATE = 40, 4.0


def render(rotation, width=WIDTH, height=HEIGHT, device=None):
    clip, faces, _, normals, _ = cube_scene(rotation, width, height,
                                            device=device)
    albedo = torch.ones_like(normals)
    lit = lighting.diffuse_directional(
        normals, albedo, LIGHT_DIRECTION,
        light_color=(1., 1., 1.)) * 0.8 + albedo * 0.2
    return dirt_tpu_torch.rasterise(
        torch.zeros(height, width, 3, device=normals.device), clip, lit,
        faces)


def render_angle(angle, width, height):
    return render(torch.stack([0. * angle, angle, 0. * angle]), width,
                  height)


def fit(steps=STEPS, device=None, log=print):
    """Recovers the yaw angle by gradient descent on the mean squared
    image error; returns (the loss of every step, the angle)."""
    device = input_device((), device)
    target = render_angle(torch.tensor(TARGET_ANGLE, device=device),
                          FIT_WIDTH, FIT_HEIGHT).detach()
    angle = torch.tensor(START_ANGLE, device=device)
    losses = []
    for step in range(steps):
        leaf = angle.clone().requires_grad_(True)
        loss = torch.mean((render_angle(leaf, FIT_WIDTH, FIT_HEIGHT)
                           - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        angle = angle - LEARNING_RATE * leaf.grad
        if step % 5 == 0:
            log(f'step {step:2d} loss {losses[-1]:.6f} '
                f'angle {float(angle):.4f}')
    log(f'recovered angle {float(angle):.4f}, target {TARGET_ANGLE}')
    return losses, angle


def main():
    args = parse_args(__doc__.splitlines()[0])
    with torch.no_grad():
        image = render([0., 0.5, 0.], device=args.device)
    save_ppm(os.path.join(args.out, 'simple.ppm'), image)
    fit(device=args.device)


if __name__ == '__main__':
    main()
