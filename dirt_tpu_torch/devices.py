"""Where the port's entry points put inputs that are not tensors yet.

The port runs on the CUDA card unless the caller asks for the CPU, by
passing CPU tensors or ``device="cpu"``.  Numpy arrays and Python numbers
are not a request for the CPU: without a ``device`` they go to the card,
and where there is none the call raises instead of quietly running on
the CPU.
"""

import torch


def input_device(values, device=None):
    """The device an entry point's `values` go to.

    When any value is a tensor, the tensors decide: they must lie on one
    device (a `device` naming another one raises).  Otherwise the values
    go to `device`, and without one to CUDA, which must then exist."""
    found = {v.device for v in values if isinstance(v, torch.Tensor)}
    if len(found) > 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(str(d) for d in found)}")
    if found:
        (tensors_device,) = found
        if device is not None and not _same(torch.device(device),
                                            tensors_device):
            raise ValueError(f"device={device!r} but the input tensors lie "
                             f"on {tensors_device}")
        return tensors_device
    chosen = torch.device("cuda" if device is None else device)
    if chosen.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: dirt_tpu_torch runs on the card unless asked "
            "for the CPU -- pass device='cpu' or CPU tensors")
    return chosen


def _same(wanted, actual):
    return wanted.type == actual.type and (
        wanted.index is None or wanted.index == actual.index)


def as_f32(x, device):
    """`x` as a float32 tensor on `device` (a tensor already there keeps
    its autograd graph)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)
