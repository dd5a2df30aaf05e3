"""The cell's inputs, made on the device from the seed.

Both sides, the program and the reference, get these same tensors: the
object-space mesh (the configuration's mesh module, meshes/<kind>.py),
a pool of rotation batches (step k takes entry k mod pool), the entry
point's own tensors with the background (entries/<entry>.py's `draw`)
and the loss weights, drawn in that order from one generator.
"""

import random
from dataclasses import dataclass

import torch


@dataclass
class Inputs:
    homogeneous: torch.Tensor    # [V, 4] object space
    faces: torch.Tensor          # [B, F, 3] int32
    pool: torch.Tensor           # [P, B, 3] rotation vectors
    background: torch.Tensor     # [B, H, W, C] the rasterised buffer's
    weights: torch.Tensor        # [B, H, W, 3] loss weights
    tensors: dict                # the entry point's own, by name
    mesh: dict                   # the mesh's per-vertex arrays beside its
    # positions, by name


def make_inputs(cell, seed, device):
    """The cell's inputs from `seed`, drawn on `device` in a few calls."""
    config, traffic = cell.config, cell.traffic
    arrays = dict(cell.mesh_module().make(config["mesh"]))
    vertices, faces = arrays.pop("vertices"), arrays.pop("faces")
    batch, height, width = config["batch"], config["height"], config["width"]
    num_vertices = vertices.shape[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    uniform = lambda *shape: torch.rand(shape, generator=generator,
                                        device=device)
    homogeneous = torch.cat([torch.as_tensor(vertices, device=device),
                             torch.ones(num_vertices, 1, device=device)], 1)
    faces = torch.as_tensor(faces, device=device).expand(
        batch, -1, -1).contiguous()
    pool = uniform(traffic["pool"], batch, 3) * 2 - 1
    tensors = cell.entry_module().draw(config, num_vertices, generator,
                                       device)
    background = tensors.pop("background")
    return Inputs(homogeneous=homogeneous, faces=faces, pool=pool,
                  background=background,
                  weights=uniform(batch, height, width, 3), tensors=tensors,
                  mesh={name: torch.as_tensor(array, device=device)
                        for name, array in arrays.items()})


def kept_samples(seed, traffic, batch):
    """The pool entries whose latest outputs the window keeps for the
    check, each with the image of the batch whose pixels it keeps: drawn
    from `seed`."""
    rng = random.Random(seed)
    entries = rng.sample(range(traffic["pool"]), traffic["kept_entries"])
    return {entry: rng.randrange(batch) for entry in entries}
