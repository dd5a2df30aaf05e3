"""Pixel-to-ray unprojection (PyTorch port of dirt_tpu/projection.py).

API parity with the reference ``dirt/projection.py``.  Tensor arguments
keep their device; arguments that are all Python or numpy values go to
``device``, and without one to the CUDA card (devices.py).
"""

import torch

from .devices import input_device


def _pixel_to_ndc(pixel_locations, image_size):
    # Reference: dirt/projection.py:6-7 (the y-flip: pixel y runs down,
    # NDC y runs up).
    flip = torch.tensor([1., -1.], dtype=torch.float32,
                        device=pixel_locations.device)
    return (-1. + 2. * pixel_locations / image_size) * flip


def _unproject_ndc_to_world(x_ndc, clip_to_world_matrix):
    # x_ndc and result are indexed by *, x/y/z (not homogeneous).  The
    # z-coordinate of the result has no intuitive meaning but is affinely
    # related to the world-space z.  Reference: dirt/projection.py:10-19.
    homogeneous = torch.cat([x_ndc, torch.ones_like(x_ndc[..., :1])], dim=-1)
    x_world_scaled = (homogeneous[..., None, :]
                      @ clip_to_world_matrix)[..., 0, :]
    return x_world_scaled[..., :3] / x_world_scaled[..., 3:]


def unproject_pixels_to_rays(pixel_locations, clip_to_world_matrix,
                             image_size, device=None):
    """Computes world-space ray start points and deltas for the given pixels.

    Args:
        pixel_locations: [A1..An, B1..Bm, 2] (x, y) pixel coordinates, where
            the Ai are batch dims over which the projection parameters vary
            and the Bi are per-image pixel dims.
        clip_to_world_matrix: [A1..An, 4, 4]; typically
            inv(world_to_view @ projection).
        image_size: int [A1..An, 2] giving (width, height).
        device: where inputs that are not tensors go (default: the CUDA
            card); tensors keep their own device.

    Returns:
        (ray_starts_world, ray_deltas_world): each [A1..An, B1..Bm, 3].
        Starts lie on the near plane (NDC z = -1); deltas point away from
        the camera (towards NDC z = 0).

    Reference: dirt/projection.py:22-70.
    """
    device = input_device((pixel_locations, clip_to_world_matrix,
                           image_size), device)
    pixel_locations = torch.as_tensor(pixel_locations, dtype=torch.float32,
                                      device=device)
    clip_to_world_matrix = torch.as_tensor(
        clip_to_world_matrix, dtype=torch.float32, device=device)
    image_size = torch.as_tensor(image_size, dtype=torch.int32,
                                 device=device)

    per_iib_dims = pixel_locations.dim() - image_size.dim()  # m above
    image_size = image_size.reshape(
        image_size.shape[:-1] + (1,) * per_iib_dims + (2,))
    clip_to_world_matrix = clip_to_world_matrix.reshape(
        clip_to_world_matrix.shape[:-2] + (1,) * per_iib_dims + (4, 4))

    pixel_locations_ndc = _pixel_to_ndc(pixel_locations,
                                        image_size.to(torch.float32))
    near = torch.cat([pixel_locations_ndc,
                      -torch.ones_like(pixel_locations_ndc[..., :1])], dim=-1)
    mid = torch.cat([pixel_locations_ndc,
                     torch.zeros_like(pixel_locations_ndc[..., :1])], dim=-1)
    ray_starts_world = _unproject_ndc_to_world(near, clip_to_world_matrix)
    ray_deltas_world = (_unproject_ndc_to_world(mid, clip_to_world_matrix)
                        - ray_starts_world)
    return ray_starts_world, ray_deltas_world
