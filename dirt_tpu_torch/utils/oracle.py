"""ctypes binding of the native C++ rasterisation oracle.

Loads the repository's tracked native/build/libraster_oracle.so (built from
native/raster_oracle.cpp with -ffp-contract=off).  If that library cannot
be loaded on this host, it is rebuilt from the same source into the port's
git-ignored build directory; the tracked library is never rewritten.
Mirrors dirt_tpu/utils/oracle.py.
"""

import ctypes
import pathlib
import subprocess

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "raster_oracle.cpp"
_TRACKED = _REPO / "native" / "build" / "libraster_oracle.so"
_BUILD_DIR = _REPO / "dirt_tpu_torch" / "_build"
_lib = None


def _rebuild():
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / "libraster_oracle.so"
    if not out.exists():
        # The Makefile's flags: every multiply and add rounds separately.
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-ffp-contract=off",
             "-fno-fast-math", "-o", str(out), str(_SOURCE)], check=True)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_TRACKED))
    except OSError:
        lib = ctypes.CDLL(str(_rebuild()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    fn = lib.dirt_oracle_rasterise
    fn.restype = None
    fn.argtypes = [f32p, f32p, f32p, i32p, i32, i32, i32, i32, i32,
                   f32p, i32p]
    _lib = lib
    return lib


def rasterise(background, vertices, vertex_colors, faces):
    """Rasterises one image with the native oracle.

    Args are numpy arrays (or anything np.asarray accepts) for one image:
    background [H, W, C], vertices [V, 4], vertex_colors [V, C], faces
    [F, 3].  Returns (pixels [H, W, C] float32, face_index [H, W] int32).
    """
    lib = _load()
    background = np.ascontiguousarray(background, np.float32)
    vertices = np.ascontiguousarray(vertices, np.float32)
    vertex_colors = np.ascontiguousarray(vertex_colors, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    height, width, channels = background.shape
    pixels = np.empty_like(background)
    face_index = np.empty((height, width), np.int32)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.dirt_oracle_rasterise(
        fptr(background), fptr(vertices), fptr(vertex_colors), iptr(faces),
        vertices.shape[0], faces.shape[0], height, width, channels,
        fptr(pixels), iptr(face_index))
    return pixels, face_index
