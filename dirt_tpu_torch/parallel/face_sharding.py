"""Face-parallel rasterisation: shard the MESH, not the batch (PyTorch
port of dirt_tpu/parallel/face_sharding.py).

Each rank of the mesh's face axis rasterises a contiguous slice of the
face list into a private framebuffer; per pixel the ranks then keep the
lexicographic (depth, global face index) minimum the single-card
z-buffer uses.  The merge is associative and commutative, so it is two
all_reduce(MIN)s (depth first, then the global face index among the
depth-sharers), and the winning rank's shaded pixel and aux row reach
every rank through a masked all_reduce(SUM).  This splits the O(faces x
covered pixels) sweep, the dominant cost of large meshes, across ranks
for O(pixels) of combine traffic.

Gradients keep the filter-based semantics and split along the face-keyed
lines of the block-binned gradient (position rows mask the post-dilation
face plane, colour rows the pre-dilation one): each rank runs ONE
parts="all" blocks gradient over its face slice, against the COMBINED
aux with the face ids remapped into its local range (winners of other
ranks get the sentinel _FOREIGN, which no table row matches), and the
per-vertex rows meet in one all_reduce(SUM) each.  Scharr filtering and
occluder dilation run on the combined image, so occluder adoption across
ranks is the unsharded one; the background gradient is pixel-keyed, the
same on every rank, with no collective.  The face ids are only ever
compared (the gradient's face planes), never used to index.

Depth for the cross-rank compare is recomputed at each pixel's local
winner with the spec expression (geometry.fragment_cover_depth), the
same expression tree the sweeps rank faces with, so the forward is the
unsharded image: pixels and every aux field, up to the sign of zero (the
masked sum makes -0.0 +0.0, as dirt_tpu's psum does).  Keep this module
eager: no torch.compile, whose fused kernels may contract a product and
a sum into an FMA.

The collectives mutate their input and have no gradient, so the forward
runs under no_grad inside a torch.autograd.Function (dirt_tpu's
custom_vjp) and every collective reduces a fresh copy.

SPMD over torch.distributed (launch.run_ranks): every rank passes the
same global inputs; the faces shard over the mesh's `axis_name`, and with
`batch_axis` (a 2-D mesh) the batch shards too, each batch group running
its own face-parallel render.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import rasterise_ops
from ..ops import backward as _backward
from ..ops import dispatch as _dispatch
from ..ops import geometry as _geometry
from ..ops.reference import RasterAux
from .sharding import BATCH_AXIS

FACE_AXIS = "faces"
# Sentinel face id: above any real global face index (the 2^24 exact-f32
# bound caps real ids far below), never a local table id, and exact in
# f32 for the gradient's face planes.
_FOREIGN = 2 ** 30


def make_face_mesh(world_size=None, device_type="cuda", batch_shards=None,
                   axis_name=FACE_AXIS):
    """A DeviceMesh over ranks 0 .. world_size - 1 (default: the whole
    default group): 1-D over the face axis, or with `batch_shards` b a
    2-D (b, world_size / b) mesh named (BATCH_AXIS, axis_name)."""
    if world_size is None:
        world_size = dist.get_world_size()
    ranks = torch.arange(world_size)
    if batch_shards is None:
        return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))
    if world_size % batch_shards:
        raise ValueError(f"world size {world_size} not divisible by "
                         f"{batch_shards} batch shards")
    return DeviceMesh(device_type, ranks.reshape(batch_shards, -1),
                      mesh_dim_names=(BATCH_AXIS, axis_name))


def _axis(mesh, name):
    """(process group, this rank's coordinate, size) of mesh axis
    `name`."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


def _all_reduce(tensor, op, group):
    out = tensor.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _winner_depth(vertices, faces_local, face_index, height, width):
    """[B, H, W] depth of each pixel's local winner, +inf where uncovered:
    the spec expression on the winner's own face constants at the pixel's
    centre, read at a safe index (uncovered pixels read face 0)."""
    x_ndc, y_ndc = _geometry.pixel_centre_ndc(height, width, vertices.device)
    setup = _geometry.face_setup(vertices, faces_local)
    covered = face_index >= 0
    safe = torch.where(covered, face_index, 0).long()
    b = torch.arange(face_index.shape[0], device=vertices.device)[:, None,
                                                                  None]
    pick = lambda a: a[b, safe]
    _, depth = _geometry.fragment_cover_depth(
        pick(setup.e), pick(setup.z), pick(setup.w), pick(setup.accept),
        pick(setup.valid), x_ndc[None, :], y_ndc[:, None])
    return torch.where(covered, depth, torch.inf)


def _forward_combine(background, vertices, vertex_colors, faces_local, axis,
                     backend):
    """Local rasterisation + the cross-rank lexicographic winner combine.
    Returns (pixels, combined RasterAux with GLOBAL face ids)."""
    group, rank, _ = axis
    nloc = faces_local.shape[1]
    height, width = background.shape[1], background.shape[2]
    with torch.no_grad():
        # Over a zero background: covered pixels never read it, so the
        # winner's shaded value is the unsharded one; the real background
        # composites after the combine.
        local_px, local_aux = _dispatch.forward_batch(
            torch.zeros_like(background), vertices, vertex_colors,
            faces_local, backend)
        covered = local_aux.face_index >= 0
        depth = _winner_depth(vertices, faces_local, local_aux.face_index,
                              height, width)
        gface = torch.where(covered, local_aux.face_index + rank * nloc,
                            _FOREIGN)
        dmin = _all_reduce(depth, dist.ReduceOp.MIN, group)
        # Ties at the minimal depth resolve by global face index: within a
        # rank the sweep already did, and contiguous slices make local
        # order global order.
        cand = torch.where(covered & (depth == dmin), gface, _FOREIGN)
        fmin = _all_reduce(cand, dist.ReduceOp.MIN, group)
        win = (covered & (gface == fmin))[..., None]
        covered_any = (fmin < _FOREIGN)[..., None]

        channels = local_px.shape[-1]
        floats = _all_reduce(torch.where(win, torch.cat(
            [local_px, local_aux.barycentric, local_aux.clip_w[..., None]],
            dim=-1), 0.0), dist.ReduceOp.SUM, group)
        ints = torch.where(win, torch.cat(
            [gface[..., None], local_aux.indices], dim=-1), 0)
        ints = _all_reduce(torch.cat([ints.reshape(-1), local_aux.dropped]),
                           dist.ReduceOp.SUM, group)
        dropped = ints[win.numel() * 4:]
        ints = ints[:win.numel() * 4].reshape(win.shape[:-1] + (4,))
        pixels = torch.where(covered_any, floats[..., :channels], background)
        aux = RasterAux(
            face_index=torch.where(covered_any[..., 0], ints[..., 0], -1),
            indices=torch.where(covered_any, ints[..., 1:], -1),
            barycentric=torch.where(covered_any,
                                    floats[..., channels:channels + 3], -1.0),
            clip_w=torch.where(covered_any[..., 0], floats[..., -1],
                               torch.inf),
            dropped=dropped)
    return pixels, aux


class _FaceShardedCore(torch.autograd.Function):
    """Forward: _forward_combine; backward: this rank's blocks gradient
    over its face slice, the vertex and colour rows summed over the
    axis."""

    @staticmethod
    def forward(ctx, background, vertices, vertex_colors, faces_local, axis,
                backend):
        pixels, aux = _forward_combine(background, vertices, vertex_colors,
                                       faces_local, axis, backend)
        ctx.save_for_backward(vertices, faces_local, pixels, aux.face_index,
                              aux.indices, aux.barycentric, aux.clip_w)
        ctx.axis = axis
        return pixels

    @staticmethod
    def backward(ctx, grad_pixels):
        vertices, faces_local, pixels, face_index, *rest = ctx.saved_tensors
        group, rank, _ = ctx.axis
        nloc = faces_local.shape[1]
        # Combined (global) ids into the local table's range; winners of
        # other ranks keep covered semantics (their vertex triples,
        # barycentrics and clip w still drive Scharr, dilation and the
        # background mask) under an id no local row matches, so each row
        # sums on its owning rank only and the all_reduce is a disjoint
        # union.
        covered = face_index >= 0
        local_ids = face_index - rank * nloc
        foreign = covered & ((local_ids < 0) | (local_ids >= nloc))
        face_local = torch.where(
            covered, torch.where(foreign, _FOREIGN, local_ids), -1)
        grad_background, grad_vertices, grad_colors = (
            _backward.rasterise_grad_grouped(
                vertices, faces_local, pixels, grad_pixels.contiguous(),
                RasterAux(face_local, *rest), parts="all",
                implementation="blocks"))
        return (grad_background,
                _all_reduce(grad_vertices, dist.ReduceOp.SUM, group),
                _all_reduce(grad_colors, dist.ReduceOp.SUM, group),
                None, None, None)


def _face_slice(mesh, axis_name, faces):
    """(this rank's contiguous face slice, the axis)."""
    axis = _axis(mesh, axis_name)
    _, rank, size = axis
    if faces.shape[1] % size:
        raise ValueError(f"face count {faces.shape[1]} not divisible by "
                         f"mesh axis {axis_name} size {size}")
    nloc = faces.shape[1] // size
    return faces[:, rank * nloc:(rank + 1) * nloc].contiguous(), axis


def rasterise_batch_face_sharded(mesh, background, vertices, vertex_colors,
                                 faces, backend=None, axis_name=FACE_AXIS,
                                 batch_axis=None, device=None):
    """Rasterises with the FACE list sharded across the mesh.

    Every rank passes the same global arguments, as rasterise_batch's,
    with `faces` [batch, F, 3], F divisible by the size of the mesh's
    `axis_name`.  Returns the pixels, differentiable wrt background,
    vertices and vertex_colors with the single-card path's filter-based
    gradients, the same on every rank of the face axis (module
    docstring).

    `batch_axis` composes this with data parallelism on a 2-D mesh
    (make_face_mesh(batch_shards=b)): the batch, divisible by that axis's
    size, shards over it, each rank returns its batch shard's pixels, and
    the gradients reach only the rows of that shard (dirt_tpu's global
    result is the shards' concatenation in rank order).  The combine's
    collectives only ever span the face axis.  Inputs that are not
    tensors go to `device`, without one to the card (devices.py).
    """
    background, vertices, vertex_colors, faces = rasterise_ops._as_inputs(
        background, vertices, vertex_colors, faces, device)
    faces_local, axis = _face_slice(mesh, axis_name, faces)
    if batch_axis is not None:
        _, rank, size = _axis(mesh, batch_axis)
        if background.shape[0] % size:
            raise ValueError(f"batch {background.shape[0]} not divisible by "
                             f"mesh axis {batch_axis} size {size}")
        shard = background.shape[0] // size
        rows = slice(rank * shard, (rank + 1) * shard)
        background, vertices, vertex_colors, faces_local = (
            background[rows], vertices[rows], vertex_colors[rows],
            faces_local[rows])
    chosen = _dispatch.resolve_backend(backend, background.device,
                                       faces_local.shape[1])
    return _FaceShardedCore.apply(background, vertices, vertex_colors,
                                  faces_local, axis, chosen)


def rasterise_batch_face_sharded_with_aux(mesh, background, vertices,
                                          vertex_colors, faces, backend=None,
                                          axis_name=FACE_AXIS, device=None):
    """Forward only: (pixels, combined RasterAux) with GLOBAL face ids,
    the diagnostic twin of rasterise_batch_with_aux (aux.dropped sums the
    ranks' counts).  Not attached to autograd."""
    background, vertices, vertex_colors, faces = rasterise_ops._as_inputs(
        background, vertices, vertex_colors, faces, device)
    faces_local, axis = _face_slice(mesh, axis_name, faces)
    chosen = _dispatch.resolve_backend(backend, background.device,
                                       faces_local.shape[1])
    return _forward_combine(background, vertices, vertex_colors, faces_local,
                            axis, chosen)
