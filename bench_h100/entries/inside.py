"""rasterise_batch with the camera inside the mesh: the direct entry
point's step (entries/direct.py), checked against the plain reference
whose windows come from the faces clipped to the near and far planes
(reference/clipped.py)."""

from bench_h100.entries.direct import (  # noqa: F401  (the step's hooks)
    LEAVES, draw, rasterise, scene)
from bench_h100.reference import clipped


def reference(clip, leaves, inputs):
    return clipped.rasterise_batch(leaves["background"], clip,
                                   leaves["colors"], inputs.faces)
