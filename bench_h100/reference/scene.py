"""Scene math, plain PyTorch: the transforms the benchmark's step applies
to its inputs, in the same order and with the same operations.

Matrices right-multiply row vectors ([*, in, out]).  Matrix products run
in full float32 (the callers switch TF32 off); `round_operands` stands in
for a lower precision by rounding every matrix product's operands first.
"""

import torch


def rodrigues(vectors):
    """[*, 4, 4] rotations from [*, 3] angle-axis vectors."""
    vectors = vectors + 1.e-12      # keeps the derivative finite at zero
    norms = torch.linalg.norm(vectors, dim=-1, keepdim=True)
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
    r = c * eye + (1 - c) * units[..., :, None] * units[..., None, :] + s * K
    return torch.cat([
        torch.cat([r, torch.zeros_like(r[..., :, :1])], dim=-1),
        torch.cat([torch.zeros_like(r[..., :1, :]),
                   torch.ones_like(r[..., :1, :1])], dim=-1),
    ], dim=-2)


def translation(x):
    zeros = torch.zeros_like(x[..., 0])
    ones = torch.ones_like(zeros)
    return torch.stack([
        torch.stack([ones, zeros, zeros, zeros], dim=-1),
        torch.stack([zeros, ones, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, ones, zeros], dim=-1),
        torch.stack([x[..., 0], x[..., 1], x[..., 2], ones], dim=-1),
    ], dim=-2)


def perspective_projection(near, far, right, aspect, device):
    """OpenGL-convention perspective projection [4, 4]."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    near, far, right, aspect = t(near), t(far), t(right), t(aspect)
    top = right * aspect
    zeros, ones = torch.zeros_like(near), torch.ones_like(near)
    return torch.stack([
        torch.stack([near / right, zeros, zeros, zeros], dim=-1),
        torch.stack([zeros, near / top, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, -(far + near) / (far - near), -ones],
                    dim=-1),
        torch.stack([zeros, zeros, -2. * far * near / (far - near), zeros],
                    dim=-1),
    ], dim=-2)


def tf32(x):
    """`x` rounded to TF32's 10-bit mantissa (round to nearest, ties away
    from zero), as the tensor cores read float32 operands in TF32 mode."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _unbroadcast(grad, shape):
    while grad.dim() > len(shape):
        grad = grad.sum(dim=0)
    return grad


class _TF32Matmul(torch.autograd.Function):
    """a @ b on TF32 operands, forward and backward alike."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = tf32(grad)
        grad_a = _unbroadcast(g @ tf32(b).transpose(-1, -2), a.shape)
        grad_b = _unbroadcast(tf32(a).transpose(-1, -2) @ g, b.shape)
        return grad_a, grad_b


def _matmul(round_operands):
    return _TF32Matmul.apply if round_operands else torch.matmul


def camera(right, distance, device, round_operands=False):
    """(view, projection) [4, 4] of the benchmark's camera: the view
    translation(0, 0, -distance) after rodrigues(-0.4, 0, 0), and the
    projection (near 0.1, far 20, half-width `right`, aspect 1)."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    view = _matmul(round_operands)(translation(t([0., 0., -distance])),
                                   rodrigues(t([-0.4, 0., 0.])))
    return view, perspective_projection(0.1, 20., right, 1., device)


def clip_vertices(homogeneous, rotation_vectors, view, projection,
                  round_operands=False):
    """Clip-space vertices [B, V, 4] of object-space homogeneous vertices
    [V, 4] under per-image rotations [B, 3], then view and projection;
    with `round_operands`, every product on TF32 operands."""
    rotations = rodrigues(rotation_vectors)
    if round_operands:
        mm = _matmul(True)
        clip = mm(homogeneous, rotations)
    else:
        mm = torch.matmul
        clip = torch.einsum("vi,bij->bvj", homogeneous, rotations)
    return mm(mm(clip, view), projection).contiguous()


def shader(gbuffer, light):
    """Ambient + Lambert (relu(n . l)) on the albedo, times the mask, plus
    [0, 0, 0.3] where the mask is 0, on the 10-channel G-buffer (mask,
    clip xyz, albedo, unit normals)."""
    sky = torch.tensor([0., 0., 0.3], device=light.device)
    mask = gbuffer[..., :1]
    albedo, normals = gbuffer[..., 4:7], gbuffer[..., 7:10]
    lambert = torch.relu((normals * light).sum(dim=-1, keepdim=True))
    return albedo * (0.2 + lambert) * mask + sky * (1.0 - mask)


def gbuffer_attributes(clip, albedo, normals):
    """The 10 vertex attributes: mask 1, clip xyz, albedo, normals."""
    return torch.cat([torch.ones_like(clip[..., :1]), clip[..., :3],
                      albedo, normals], dim=-1).contiguous()
