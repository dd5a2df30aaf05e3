"""The system under test: one closed-loop training-style step of the
PyTorch port, as a user who fits poses and colours to images runs it.

Step k takes pool entry k mod P as its rotation leaf, builds clip-space
vertices with dirt_tpu_torch.matrices (rodrigues, then the camera's view
and projection, made once), calls the cell's entry point through its
module's hooks (entries/<entry>.py: its scene work, its call into the
port, its shader), takes loss = sum(pixels * weights), back-propagates
it to the rotations, the entry point's leaves and the background, and
reads the loss back to the host.  The backend is the port's default
dispatch.
"""

import contextlib
import time
from collections import defaultdict

import torch

_NO_SPAN = contextlib.nullcontext()


class Spans:
    """The benchmark's own spans around its calls into each layer: the
    host seconds spent in each summed while `counting`, and a
    torch.profiler.record_function range each while `on`."""

    def __init__(self):
        self.on = False
        self.counting = False
        self.seconds = defaultdict(float)

    def __call__(self, name):
        return self._span(name) if self.on or self.counting else _NO_SPAN

    @contextlib.contextmanager
    def _span(self, name):
        with torch.profiler.record_function(name) if self.on else _NO_SPAN:
            start = time.perf_counter()
            yield
            if self.counting:
                self.seconds[name] += time.perf_counter() - start


class Program:
    """The step over the cell's inputs; keeps, for the pool entries of
    `kept` ({entry: image}), the outputs of the latest step that took
    each entry."""

    def __init__(self, cell, inputs, kept, spans):
        import dirt_tpu_torch
        from dirt_tpu_torch import matrices
        traffic, entry = cell.traffic, cell.entry_module()
        self.port = dirt_tpu_torch
        self.entry = entry
        self.scene = entry.scene
        self.rasterise = entry.rasterise
        self.rodrigues = matrices.rodrigues
        self.inputs = inputs
        self.spans = spans
        self.kept = kept
        self.outputs = {}
        self._last = None
        device = inputs.homogeneous.device
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.view = matrices.compose(
            matrices.translation(t([0., 0., -traffic["distance"]])),
            matrices.rodrigues(t([-0.4, 0., 0.])))
        self.projection = matrices.perspective_projection(
            near=0.1, far=20., right=traffic["half_width"], aspect=1.,
            device=device)
        leaf = lambda x: x.detach().clone().requires_grad_(True)
        self.rotations = [leaf(r) for r in inputs.pool]
        self.background = leaf(inputs.background)
        self.leaves = dict(background=self.background,
                           **{name: leaf(inputs.tensors[name])
                              for name in entry.LEAVES})

    def _shade(self, gbuffer):
        with self.spans("shader"):
            return self.entry.shade(gbuffer, self.leaves)

    def step(self, k):
        """Step k; returns the loss as a Python float."""
        span, inputs, leaves = self.spans, self.inputs, self.leaves
        rotation = self.rotations[k % len(self.rotations)]
        rotation.grad = None
        for x in leaves.values():
            x.grad = None
        with span("scene"):
            clip = (torch.einsum("vi,bij->bvj", inputs.homogeneous,
                                 self.rodrigues(rotation))
                    @ self.view @ self.projection)
            values = self.scene(clip, leaves, inputs)
        with span("rasterise"):
            pixels = self.rasterise(self.port, self.background, clip, values,
                                    inputs.faces, self._shade)
        with span("loss"):
            loss = (pixels * inputs.weights).sum()
        with span("backward"):
            loss.backward()
        with span("readback"):
            value = loss.item()
        self._last = (k, value, pixels, rotation)
        return value

    def keep(self):
        """After a step, outside its time: keeps its outputs where its
        pool entry is one the check compares."""
        k, value, pixels, rotation = self._last
        self._last = None
        entry = k % len(self.rotations)
        if entry in self.kept:
            self.outputs[entry] = outputs(value, pixels, rotation,
                                          self.leaves, self.kept[entry])


def _grad(x, image=None):
    """A copy of the leaf's gradient, or of image `image`'s part of it;
    zeros where the step gave it none.  Only that part is copied: the
    window's peak memory counts the copy."""
    grad = torch.zeros_like(x) if x.grad is None else x.grad.detach()
    return (grad if image is None else grad[image]).clone()


def outputs(loss, pixels, rotation, leaves, image):
    """What the check compares of one step: the loss, image `image`'s
    pixels and background gradient, and every other leaf's gradient."""
    grads = {name: _grad(x) for name, x in leaves.items()
             if name != "background"}
    grads["rotations"] = _grad(rotation)
    grads["background"] = _grad(leaves["background"], image)
    return dict(loss=loss, pixels=pixels[image].detach().clone(),
                grads=grads)
