"""Carries scenes and results between numpy and the port's tensors.

The rasteriser has no learned weights: its state is the scene.  Both
packages read the same numpy arrays, so both compute the same thing.
"""

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
