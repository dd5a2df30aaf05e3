"""Shared sample utilities: arguments, image output and the common cube
scene (PyTorch port of samples/common.py)."""

import argparse
import os

import numpy as np
import torch

from .. import lighting, matrices
from ..devices import input_device
from ..utils import meshes

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_out")


def parse_args(description):
    """--out DIR (default OUT_DIR) and --device (default: the card)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--out", default=OUT_DIR,
                        help="directory the PPM images go to")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args()


def save_ppm(path, pixels):
    """Writes [H, W, 3] float pixels in [0, 1] as a binary PPM image,
    quantised as samples/common.py does (clip, x 255, truncate)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = to_levels(pixels)
    h, w = data.shape[:2]
    with open(path, 'wb') as f:
        f.write(f'P6\n{w} {h}\n255\n'.encode())
        f.write(data.tobytes())
    print(f'wrote {path} ({w}x{h})')


def to_levels(pixels):
    """[H, W, 3] float pixels -> the uint8 levels save_ppm writes."""
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().cpu().numpy()
    return (np.clip(np.asarray(pixels), 0., 1.) * 255).astype(np.uint8)


def cube_scene(rotation, frame_width, frame_height,
               camera_translation=(0., -1.5, -3.5), camera_tilt=-0.3,
               device=None):
    """Split-vertex cube under a standard camera.

    Returns (clip_vertices [V,4], faces [F,3], world_vertices [V,4],
    normals_world [V,3], view_matrix [4,4]), on `rotation`'s device if it
    is a tensor, else on `device` (default: the card).
    """
    device = input_device((rotation,), device)
    vertices, faces = meshes.build_cube()
    vertices, faces = lighting.split_vertices_by_face(vertices, faces,
                                                      device=device)
    homogeneous = torch.cat([vertices, torch.ones_like(vertices[:, :1])],
                            dim=1)

    world = homogeneous @ matrices.rodrigues(rotation, device=device)
    normals = lighting.vertex_normals_pre_split(world, faces)
    view = matrices.compose(
        matrices.translation(camera_translation, device=device),
        matrices.rodrigues([camera_tilt, 0., 0.], device=device))
    projection = matrices.perspective_projection(
        near=0.1, far=20., right=0.1,
        aspect=float(frame_height) / frame_width, device=device)
    clip = world @ view @ projection
    return clip, faces, world, normals, view

