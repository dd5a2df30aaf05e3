"""The comparison that decides `correct`.

The window keeps, for a few pool entries drawn from the seed, the
outputs of the latest step that took each: the loss, one image's pixels
(drawn from the seed too) and background gradient, and every other
leaf's whole gradient (the rotations and the entry point's leaves).
Once the window has closed and the program's state is freed, the plain
reference (the entry module's `reference` on the benchmark's scene
math) recomputes the same steps from the benchmark's own inputs, and
three numbers are compared, each with the limit the cell's checks file
gives:

  pixels  the widest gap of a kept pixel, absolute (pixels lie in [0, 1]);
  grads   the widest gap of a gradient, over the leaf's largest
          reference magnitude, the worst leaf;
  loss    the loss's gap over the reference loss.

The control puts the reference in the program's place with every matrix
product of the scene math on TF32 operands (`scene.tf32`), the precision
one step below the configuration's float32 with TF32 off.
"""

import math

import torch

from ..reference import scene
from .program import outputs

NUMBERS = ("pixels", "grads", "loss")


def reference_outputs(cell, inputs, kept, round_operands=False):
    """The reference's outputs of the kept steps ({pool entry: outputs}),
    each step one pool entry's forward, loss and backward; with
    `round_operands`, the control's."""
    traffic, entry_point = cell.traffic, cell.entry_module()
    device = inputs.homogeneous.device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        view, projection = scene.camera(traffic["half_width"],
                                        traffic["distance"], device,
                                        round_operands)
        got = {}
        for entry, image in sorted(kept.items()):
            leaf = lambda x: x.detach().clone().requires_grad_(True)
            rotation = leaf(inputs.pool[entry])
            clip = scene.clip_vertices(inputs.homogeneous, rotation, view,
                                       projection, round_operands)
            leaves = dict(background=leaf(inputs.background),
                          **{name: leaf(inputs.tensors[name])
                             for name in entry_point.LEAVES})
            pixels = entry_point.reference(clip, leaves, inputs)
            loss = (pixels * inputs.weights).sum()
            loss.backward()
            got[entry] = outputs(loss.item(), pixels, rotation, leaves,
                                 image)
            del pixels, loss, clip, leaves, rotation
        return got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _finite(value):
    return value if math.isfinite(value) else math.inf


def _gap(got, want):
    return _finite(float((got.double() - want.double()).abs().max()))


def numbers(got, want):
    """{number: value} of the program's kept outputs `got` against the
    reference's `want`; inf where an entry was never kept or a value is
    not finite."""
    values = dict.fromkeys(NUMBERS, 0.0)
    for entry, ref in want.items():
        out = got.get(entry)
        if out is None:
            return dict.fromkeys(NUMBERS, math.inf)
        values["pixels"] = max(values["pixels"],
                               _gap(out["pixels"], ref["pixels"]))
        for name, grad in ref["grads"].items():
            scale = max(float(grad.abs().max()), 1e-30)
            values["grads"] = max(values["grads"],
                                  _gap(out["grads"][name], grad) / scale)
        values["loss"] = max(values["loss"], _finite(
            abs(out["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)))
    return values


def judge(values, limits):
    """True where every number is at most its limit (NaN fails)."""
    return all(values[name] <= limits[name] for name in NUMBERS)
