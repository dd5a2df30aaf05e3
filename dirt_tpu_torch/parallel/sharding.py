"""Batch data parallelism for batched rasterisation (PyTorch port of
dirt_tpu/parallel/sharding.py).

Rasterisation is embarrassingly batch-parallel: each image's tiles live on
one rank, and the only cross-rank reduction is that of the gradients of
scene parameters shared across the batch.  dirt_tpu expresses this with a
`jax.sharding.Mesh` and shard_map over global arrays.  The port is SPMD
over torch.distributed: every rank runs the same program on its own
shard, and the collectives are explicit `all_reduce`s.

How the two map onto each other: a JAX array sharded over the "batch"
axis is, in the port, the concatenation over the mesh's ranks (in rank
order) of each rank's local tensor.  `batch_sharded` cuts a global tensor
into this rank's piece; `replicated` makes every rank hold rank 0's
value.  Processes and groups come from launch.run_ranks.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import rasterise_ops

BATCH_AXIS = "batch"


def make_mesh(world_size=None, device_type="cuda", axis_name=BATCH_AXIS):
    """A 1-D DeviceMesh named `axis_name` over ranks 0 .. world_size - 1
    (default: the whole default group), for tensors on `device_type`."""
    if world_size is None:
        world_size = dist.get_world_size()
    return DeviceMesh(device_type, torch.arange(world_size),
                      mesh_dim_names=(axis_name,))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicated(mesh, tensors):
    """Every tensor of the tree `tensors` (a tensor, or dicts, lists and
    tuples of them) as rank 0's value, on every rank of the 1-D `mesh`:
    a broadcast of a copy (the inputs are left as they are)."""
    group = mesh.get_group()
    source = dist.get_global_rank(group, 0)

    def put(t):
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=source, group=group)
        return out
    return _tree_map(put, tensors)


def batch_sharded(mesh, tensors, axis_name=BATCH_AXIS):
    """This rank's piece of the leading axis of every tensor of the tree
    `tensors`: rank r of the mesh's `axis_name` takes rows [r * n / R,
    (r + 1) * n / R) of n; n must divide by the axis size R."""
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    rank = mesh.get_local_rank(axis_name)

    def piece(t):
        if t.shape[0] % size:
            raise ValueError(f"leading axis {t.shape[0]} not divisible by "
                             f"mesh axis {axis_name} size {size}")
        shard = t.shape[0] // size
        return t[rank * shard:(rank + 1) * shard]
    return _tree_map(piece, tensors)


def rasterise_batch_sharded(mesh, background, vertices, vertex_colors, faces,
                            backend=None, device=None):
    """Rasterises this rank's shard of a batch sharded over the mesh.

    The arguments are the local shards ([shard, ...], as batch_sharded
    cuts them) and so is the result, [shard, H, W, C] differentiable as
    rasterise_batch's.  dirt_tpu's shard_map takes the global arrays and
    returns the global image; here the global image is the concatenation
    of the ranks' results in rank order.  The forward needs no
    communication; data_parallel_fit_step reduces the gradients of
    parameters shared across the batch."""
    del mesh   # the shard is the whole story: no collective in the forward
    return rasterise_ops.rasterise_batch(background, vertices, vertex_colors,
                                         faces, backend=backend,
                                         device=device)


def data_parallel_fit_step(mesh, render_fn, params, targets, learning_rate):
    """One SGD step of inverse rendering, data-parallel over the 1-D mesh.

    `render_fn(params, shard_size) -> [shard, H, W, C]` renders the local
    shard from the replicated scene `params` (a dict of tensors); `targets`
    is this rank's shard.  The L2 loss, summed over all ranks with
    all_reduce(SUM), is divided by the global target size (every rank
    holds an equal shard), and so is each parameter's gradient, summed the
    same way; then one SGD update.  Returns (new_params, loss), the same
    on every rank."""
    group = mesh.get_group()
    total = targets.numel() * dist.get_world_size(group)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    rendered = render_fn(leaves, targets.shape[0])
    local = torch.sum((rendered - targets) ** 2)
    grads = torch.autograd.grad(local, list(leaves.values()),
                                allow_unused=True)
    loss = local.detach().clone()
    dist.all_reduce(loss, group=group)
    new_params = {}
    for (name, leaf), grad in zip(leaves.items(), grads):
        grad = torch.zeros_like(leaf) if grad is None else grad.clone()
        dist.all_reduce(grad, group=group)
        new_params[name] = leaf.detach() - learning_rate * (grad / total)
    return new_params, loss / total
