"""Build, load and launch counting for the hand-written Hopper kernels.

The CUDA C++ sources under dirt_tpu_torch/csrc/ are compiled by nvcc, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds).  The library name carries a hash of the
sources, the headers they share and the flags; it is built at first use
into the git-ignored dirt_tpu_torch/_build/ directory.

Flags: sm_90a, IEEE division and square root (no --use_fast_math: the
coverage test relies on NaN comparing false), and -fmad=false, so every
kernel rounds each product exactly as eager PyTorch does and can be held
bitwise against its plain version.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `Kernel.__call__` raises on a non-zero code and
otherwise counts the launch.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster_sweep.cu", "hit_plane.cu", "grad_prepass.cu",
           "grad_reduce.cu", "dense_sweep.cu", "dense_grad.cu",
           "pallas_raster.cu", "mxu_grad.cu", "resident_sweep.cu",
           "slot_sweep.cu", "slot_grad.cu", "scalar_accum.cu",
           "build_runs.cu", "face_table.cu")
HEADERS = ("sweep_math.cuh", "grad_math.cuh", "slots.cuh", "async_copy.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None
KERNELS = {}

ptr = ctypes.c_void_p
i32 = ctypes.c_int
i64 = ctypes.c_longlong
f32 = ctypes.c_float

# Colour channels a pass of a gradient kernel can take (K3, K6, K9): the
# instantiations of grad_math.cuh's GradSumsN<G>.
GROUPS = (4, 8, 12)


def colour_group(channels, want_col):
    """The colour channels a gradient kernel's pass takes: the least of
    GROUPS that covers `channels`, else the largest (then more than one
    pass); GROUPS[0] where no colour is reduced."""
    if not want_col:
        return GROUPS[0]
    return next((g for g in GROUPS if g >= channels), GROUPS[-1])


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libdirt_kernels_{digest.hexdigest()[:16]}.so"


def load():
    """Builds (once per source hash) and loads the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{path.stem}.{os.getpid()}"
        objects = [BUILD_DIR / f"{tag}.{name}.o" for name in SOURCES]
        compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                      str(CSRC / name)])
                    for name, obj in zip(SOURCES, objects)]
        failed = [name for name, proc in zip(SOURCES, compiles)
                  if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                        *(str(obj) for obj in objects)], check=True)
        os.replace(tmp, path)
        for obj in objects:
            obj.unlink()
    _lib = ctypes.CDLL(str(path))
    return _lib


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name, symbol, argtypes, replaces, source):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces      # "file:line" of each TPU kernel def,
        # or None for a kernel that replaces none (its source says why)
        self.source = source          # its file under csrc/
        self.launches = 0
        KERNELS[name] = self

    def __call__(self, *args):
        fn = getattr(load(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1


def shared_memory_optin(device):
    """The shared memory one block of `device` may opt in to, in bytes
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    index = torch.device(device).index
    return _optin(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _optin(index):
    """shared_memory_optin of device `index`, queried once: K3 and K6 read
    it at every launch."""
    fn = load().dirt_shared_memory_optin
    fn.argtypes = [i32, ctypes.POINTER(i32)]
    fn.restype = ctypes.c_int
    out = i32(0)
    err = fn(index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: error {err}")
    return out.value


def reset_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(name, tensor, dtype, shape=None):
    """Validates a tensor handed to a kernel: CUDA, dtype, contiguity and
    (optionally) shape.  Returns its data pointer."""
    if not tensor.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(tensor.shape)}")
    return tensor.data_ptr()


def on_cuda(*tensors):
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); any other device raises."""
    devices = {t.device.type for t in tensors}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU, got "
                     f"{sorted(devices)}")
