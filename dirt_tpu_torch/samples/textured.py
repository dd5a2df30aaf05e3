"""Textured deferred-shading sample with texture-recovery inverse
rendering (PyTorch port of samples/textured.py).

Rasterises a 6-channel G-buffer (mask, UVs, normals), samples the
repository's photographic texture (samples/texture.jpg) with bilinear
filtering inside the shader, lights it, and then recovers the texture
from the rendered image by descending through the UV/texture-sampling
gradients.  Falls back to a procedural stripe texture where the image or
PIL is unavailable, and says so.

    python -m dirt_tpu_torch.samples.textured [--out DIR] [--device cpu]
"""

import os

import numpy as np
import torch

import dirt_tpu_torch
from .. import lighting, matrices
from ..devices import input_device
from ..utils import textures
from .common import parse_args, save_ppm

WIDTH, HEIGHT = 640, 480
TEXTURE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'samples', 'texture.jpg')
FIT_WIDTH, FIT_HEIGHT = 160, 120
STEPS, LEARNING_RATE = 15, 2000.0


def icosahedron_like_prism():
    """A UV-mapped hexagonal prism (distinct geometry from the cube demos)."""
    segments = 6
    angles = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    top = np.stack([np.cos(angles), np.ones(segments), np.sin(angles)], 1)
    bottom = top * [1., -1., 1.]
    vertices, uvs, faces = [], [], []
    for i in range(segments):
        j = (i + 1) % segments
        base = len(vertices)
        u0, u1 = i / segments, (i + 1) / segments
        vertices += [top[i], top[j], bottom[j], bottom[i]]
        uvs += [[u0 * 4, 0.], [u1 * 4, 0.], [u1 * 4, 1.], [u0 * 4, 1.]]
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.asarray(vertices, np.float32), np.asarray(uvs, np.float32),
            np.asarray(faces, np.int32))


def stripes_texture(size=128):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.stack([
        0.5 + 0.5 * np.sin(x * 20),
        0.5 + 0.5 * np.cos(y * 14),
        0.4 + 0.4 * ((np.floor(x * 6) + np.floor(y * 6)) % 2),
    ], axis=-1).astype(np.float32)


def photo_texture(size=128, log=print):
    """The checked-in photo resized to [size, size, 3] in [0, 1] (numpy),
    or the procedural stripes where it or PIL is unavailable."""
    try:
        from PIL import Image
        with Image.open(TEXTURE_PATH) as im:
            im = im.convert('RGB').resize((size, size), Image.BILINEAR)
            return np.asarray(im, np.float32) / 255.0
    except (ImportError, OSError) as exc:
        log(f'photo texture unavailable ({exc}); using stripes')
        return stripes_texture(size)


def scene_clip_vertices(vertices_obj, device):
    vertices_obj = torch.as_tensor(vertices_obj, device=device)
    homogeneous = torch.cat(
        [vertices_obj, torch.ones(len(vertices_obj), 1, device=device)],
        dim=1)
    world = homogeneous @ matrices.rodrigues([0.2, 0.7, 0.], device=device)
    view = matrices.compose(
        matrices.translation([0., -0.4, -4.0], device=device),
        matrices.rodrigues([-0.35, 0., 0.], device=device))
    projection = matrices.perspective_projection(
        near=0.1, far=20., right=0.1, aspect=float(HEIGHT) / WIDTH,
        device=device)
    return world, world @ view @ projection


def render(texture, width=WIDTH, height=HEIGHT, device=None):
    device = input_device((texture,), device)
    texture = torch.as_tensor(texture, dtype=torch.float32, device=device)
    vertices_obj, uvs, faces = icosahedron_like_prism()
    faces = torch.as_tensor(faces, device=device)
    world, clip = scene_clip_vertices(vertices_obj, device)
    normals = lighting.vertex_normals(world[:, :3], faces)

    def shader_fn(gbuffer, tex, light_direction):
        mask = gbuffer[:, :, :1]
        uv = gbuffer[:, :, 1:3]
        n = gbuffer[:, :, 3:]
        base = textures.sample_texture(
            tex, textures.uvs_to_pixel_indices(uv, tex.shape[:2]))
        lit = lighting.diffuse_directional(
            n.reshape(-1, 3), base.reshape(-1, 3),
            light_direction, light_color=(0.6, 0.6, 0.6),
            double_sided=True).reshape(height, width, 3)
        background = torch.tensor([0., 0., 0.3], device=gbuffer.device)
        return (lit + base * 0.4) * mask + background * (1. - mask)

    light = torch.tensor([1., -0.3, -0.5], device=device)
    light = light / torch.linalg.norm(light)
    return dirt_tpu_torch.rasterise_deferred(
        background_attributes=torch.zeros(height, width, 6, device=device),
        vertices=clip,
        vertex_attributes=torch.cat([
            torch.ones(len(vertices_obj), 1, device=device),
            torch.as_tensor(uvs, device=device), normals,
        ], dim=1),
        faces=faces,
        shader_fn=shader_fn,
        shader_additional_inputs=[texture, light])


def fit(true_texture, steps=STEPS, device=None, log=print):
    """Recovers `true_texture` from its render, starting from grey, by
    gradient descent on the mean squared image error; returns (the loss
    of every step, the texture)."""
    device = input_device((true_texture,), device)
    true_texture = torch.as_tensor(true_texture, device=device)
    target = render(true_texture, FIT_WIDTH, FIT_HEIGHT).detach()
    texture = torch.full_like(true_texture, 0.5)
    losses = []
    for step in range(steps):
        leaf = texture.clone().requires_grad_(True)
        loss = torch.mean((render(leaf, FIT_WIDTH, FIT_HEIGHT)
                           - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        texture = texture - LEARNING_RATE * leaf.grad
        if step % 5 == 0:
            log(f'step {step:2d} loss {losses[-1]:.6f}')
    log(f'mean texel error after fit: '
        f'{float((texture - true_texture).abs().mean()):.4f}')
    return losses, texture


def main():
    args = parse_args(__doc__.splitlines()[0])
    true_texture = photo_texture()
    with torch.no_grad():
        image = render(true_texture, device=args.device)
    save_ppm(os.path.join(args.out, 'textured.ppm'), image)
    _, texture = fit(true_texture, device=args.device)
    with torch.no_grad():
        recovered = render(texture)
    save_ppm(os.path.join(args.out, 'textured_recovered.ppm'), recovered)


if __name__ == '__main__':
    main()
