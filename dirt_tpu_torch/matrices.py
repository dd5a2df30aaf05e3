"""Homogeneous transform matrices (PyTorch port of dirt_tpu/matrices.py).

Matrices *right*-multiply row vectors: they are indexed
``*, x/y/z[/w] (in), x/y/z[/w] (out)`` with any leading batch dimensions.
Scene math stays in full float32: TF32 is switched off for matrix products
and convolutions when this module is imported, as the JAX package pins
"highest" matmul precision for its cross-backend comparisons.

Every function takes a ``device`` keyword.  Tensor arguments keep their
device; arguments that are all Python or numpy values go to ``device``,
and without one to the CUDA card (see dirt_tpu_torch/devices.py).
"""

import torch

from .devices import as_f32, input_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rodrigues(vectors, three_by_three=False, device=None):
    """Angle-axis rotation matrices from [*, 3] vectors (direction = axis,
    length = angle in radians); returns [*, D, D] with D = 3 or 4."""
    # + 1e-12 keeps the derivative finite at zero.
    vectors = as_f32(vectors, input_device([vectors], device)) + 1.e-12
    norms = torch.linalg.norm(vectors, dim=-1, keepdim=True)   # [*, 1]
    units = vectors / norms
    norms = norms[..., 0]

    z = torch.zeros_like(units[..., 0])
    ux, uy, uz = units[..., 0], units[..., 1], units[..., 2]
    K = torch.stack([
        torch.stack([z, -uz, uy], dim=-1),
        torch.stack([uz, z, -ux], dim=-1),
        torch.stack([-uy, ux, z], dim=-1),
    ], dim=-2)

    c = torch.cos(norms)[..., None, None]
    s = torch.sin(norms)[..., None, None]
    eye = torch.eye(3, dtype=torch.float32, device=vectors.device)
    result_3x3 = (c * eye + (1 - c) * units[..., :, None] * units[..., None, :]
                  + s * K)
    if three_by_three:
        return result_3x3
    return pad_3x3_to_4x4(result_3x3)


def translation(x, device=None):
    """Translation matrices [*, 4, 4] from [*, 3] displacements."""
    x = as_f32(x, input_device([x], device))
    zeros = torch.zeros_like(x[..., 0])
    ones = torch.ones_like(zeros)
    return torch.stack([
        torch.stack([ones, zeros, zeros, zeros], dim=-1),
        torch.stack([zeros, ones, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, ones, zeros], dim=-1),
        torch.stack([x[..., 0], x[..., 1], x[..., 2], ones], dim=-1),
    ], dim=-2)


def scale(x, device=None):
    """Scaling matrices [*, 4, 4] from [*, 3] scale factors."""
    x = as_f32(x, input_device([x], device))
    diag = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return diag[..., :, None] * torch.eye(4, dtype=torch.float32,
                                          device=x.device)


def perspective_projection(near, far, right, aspect, device=None):
    """OpenGL-convention perspective projection matrices [*, 4, 4]
    (right-multiplying row vectors); all parameters broadcast together."""
    device = input_device([near, far, right, aspect], device)
    near, far, right, aspect = (as_f32(a, device)
                                for a in (near, far, right, aspect))
    top = right * aspect
    near, far, top, right = torch.broadcast_tensors(near, far, top, right)
    zeros = torch.zeros_like(near)
    ones = torch.ones_like(near)
    return torch.stack([
        torch.stack([near / right, zeros, zeros, zeros], dim=-1),
        torch.stack([zeros, near / top, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, -(far + near) / (far - near), -ones],
                    dim=-1),
        torch.stack([zeros, zeros, -2. * far * near / (far - near), zeros],
                    dim=-1),
    ], dim=-2)


def pad_3x3_to_4x4(matrix, device=None):
    """Pads a [*, 3, 3] transform to a [*, 4, 4] homogeneous transform."""
    matrix = as_f32(matrix, input_device([matrix], device))
    return torch.cat([
        torch.cat([matrix, torch.zeros_like(matrix[..., :, :1])], dim=-1),
        torch.cat([torch.zeros_like(matrix[..., :1, :]),
                   torch.ones_like(matrix[..., :1, :1])], dim=-1),
    ], dim=-2)


def compose(*matrices, device=None):
    """Composes transforms left to right (the first is applied first);
    the 4x4 identity for an empty sequence."""
    device = input_device(matrices, device)
    if not matrices:
        return torch.eye(4, dtype=torch.float32, device=device)
    result = as_f32(matrices[0], device)
    for m in matrices[1:]:
        result = result @ as_f32(m, device)
    return result
