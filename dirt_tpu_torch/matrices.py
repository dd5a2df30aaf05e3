"""Homogeneous transform matrices (PyTorch port of dirt_tpu/matrices.py).

Matrices *right*-multiply row vectors: they are indexed
``*, x/y/z[/w] (in), x/y/z[/w] (out)`` with any leading batch dimensions.
Scene math stays in full float32: TF32 is switched off for matrix products
and convolutions when this module is imported, as the JAX package pins
"highest" matmul precision for its cross-backend comparisons.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _f32(x, like=None):
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def rodrigues(vectors, three_by_three=False):
    """Angle-axis rotation matrices from [*, 3] vectors (direction = axis,
    length = angle in radians); returns [*, D, D] with D = 3 or 4."""
    vectors = _f32(vectors) + 1.e-12  # keeps the derivative finite at zero
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


def translation(x):
    """Translation matrices [*, 4, 4] from [*, 3] displacements."""
    x = _f32(x)
    zeros = torch.zeros_like(x[..., 0])
    ones = torch.ones_like(zeros)
    return torch.stack([
        torch.stack([ones, zeros, zeros, zeros], dim=-1),
        torch.stack([zeros, ones, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, ones, zeros], dim=-1),
        torch.stack([x[..., 0], x[..., 1], x[..., 2], ones], dim=-1),
    ], dim=-2)


def scale(x):
    """Scaling matrices [*, 4, 4] from [*, 3] scale factors."""
    x = _f32(x)
    diag = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return diag[..., :, None] * torch.eye(4, dtype=torch.float32,
                                          device=x.device)


def perspective_projection(near, far, right, aspect):
    """OpenGL-convention perspective projection matrices [*, 4, 4]
    (right-multiplying row vectors); all parameters broadcast together."""
    near, far, right, aspect = (_f32(a) for a in (near, far, right, aspect))
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


def pad_3x3_to_4x4(matrix):
    """Pads a [*, 3, 3] transform to a [*, 4, 4] homogeneous transform."""
    matrix = _f32(matrix)
    return torch.cat([
        torch.cat([matrix, torch.zeros_like(matrix[..., :, :1])], dim=-1),
        torch.cat([torch.zeros_like(matrix[..., :1, :]),
                   torch.ones_like(matrix[..., :1, :1])], dim=-1),
    ], dim=-2)


def compose(*matrices):
    """Composes transforms left to right (the first is applied first);
    the 4x4 identity for an empty sequence."""
    if not matrices:
        return torch.eye(4, dtype=torch.float32)
    result = _f32(matrices[0])
    for m in matrices[1:]:
        result = result @ _f32(m, like=result)
    return result
