"""Carries scenes, results and renderer configurations between numpy
and the port's tensors.

The rasteriser has no learned weights: its state is the scene.  Both
packages read the same numpy arrays, so both compute the same thing.  A
renderer model's state is its configuration: renderer_from_config builds
the port's renderer from the JAX renderer's dataclass fields, given as a
plain dict, so the port never imports dirt_tpu.
"""

import dataclasses

import numpy as np
import torch

_INT_KEYS = ("faces",)


def scene_to_torch(arrays, device):
    """Turns a dict of numpy scene arrays (background, vertices or clip,
    colours, faces, weights, ...) into tensors on `device`: float32,
    except "faces", which stays int32."""
    out = {}
    for key, value in arrays.items():
        dtype = torch.int32 if key in _INT_KEYS else torch.float32
        out[key] = torch.as_tensor(np.asarray(value), dtype=dtype,
                                   device=device)
    return out


def _numpy(x):
    return None if x is None else x.detach().cpu().numpy()


def aux_to_numpy(aux):
    """RasterAux of tensors -> the same named tuple of numpy arrays."""
    return type(aux)(*(_numpy(x) for x in aux))


def grads_to_numpy(grads):
    """A tuple (or named tuple) of gradient tensors -> numpy arrays."""
    values = [_numpy(x) for x in grads]
    return type(grads)(*values) if hasattr(grads, "_fields") else tuple(values)


def renderer_from_config(kind, fields):
    """The port's renderer `kind` ("GouraudRenderer",
    "DeferredPhongRenderer" or "TexturedRenderer", the JAX class's name)
    with `fields`, a dict of the JAX renderer's dataclass fields (e.g.
    dataclasses.asdict of it).  The camera may be a dict or a dataclass of
    Camera's fields; `normals_fn` is mapped by its function name
    (vertex_normals or vertex_normals_pre_split) onto the port's."""
    from .. import lighting, models
    renderers = {cls.__name__: cls for cls in (
        models.GouraudRenderer, models.DeferredPhongRenderer,
        models.TexturedRenderer)}
    if kind not in renderers:
        raise ValueError(f"unknown renderer {kind!r}; one of "
                         f"{sorted(renderers)}")
    fields = dict(fields)
    camera = fields.get("camera")
    if camera is not None and not isinstance(camera, models.Camera):
        if dataclasses.is_dataclass(camera):
            camera = dataclasses.asdict(camera)
        fields["camera"] = models.Camera(**{
            key: tuple(value) if isinstance(value, (list, np.ndarray))
            else value for key, value in camera.items()})
    if "normals_fn" in fields:
        fn = fields["normals_fn"]
        name = fn if isinstance(fn, str) else getattr(fn, "__name__", None)
        if name not in ("vertex_normals", "vertex_normals_pre_split"):
            raise ValueError(f"normals_fn {fn!r} has no counterpart in the "
                             f"port")
        fields["normals_fn"] = getattr(lighting, name)
    return renderers[kind](**fields)
