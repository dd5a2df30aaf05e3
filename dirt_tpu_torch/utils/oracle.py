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
    for name in ("dirt_oracle_rasterise", "dirt_oracle_rasterise_clipped"):
        fn = getattr(lib, name)
        fn.restype = None
        # background, vertices, colors, faces, V, F, H, W, C, out pixels,
        # out face index
        fn.argtypes = [f32p, f32p, f32p, i32p, i32, i32, i32, i32, i32,
                       f32p, i32p]
    vis64 = lib.dirt_oracle_visibility_f64
    vis64.restype = None
    # vertices, faces, V, F, H, W, out face index
    vis64.argtypes = [f32p, i32p, i32, i32, i32, i32, i32p]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _rasterise_with(fn, background, vertices, vertex_colors, faces):
    """Calls one of the oracle's two rasterisers (they share a
    signature) on one image's arrays."""
    background = np.ascontiguousarray(background, np.float32)
    vertices = np.ascontiguousarray(vertices, np.float32)
    vertex_colors = np.ascontiguousarray(vertex_colors, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    height, width, channels = background.shape
    pixels = np.empty_like(background)
    face_index = np.empty((height, width), np.int32)
    fn(_fptr(background), _fptr(vertices), _fptr(vertex_colors),
       _iptr(faces), vertices.shape[0], faces.shape[0], height, width,
       channels, _fptr(pixels), _iptr(face_index))
    return pixels, face_index


def rasterise(background, vertices, vertex_colors, faces):
    """Rasterises one image with the native oracle.

    Args are numpy arrays (or anything np.asarray accepts) for one image:
    background [H, W, C], vertices [V, 4], vertex_colors [V, C], faces
    [F, 3].  Returns (pixels [H, W, C] float32, face_index [H, W] int32).
    """
    return _rasterise_with(_load().dirt_oracle_rasterise, background,
                           vertices, vertex_colors, faces)


def visibility_f64(vertices, faces, height, width):
    """Winner map with all visibility arithmetic in double precision.

    The adjudicator of near-tie winner disagreements between f32
    implementations (sub-pixel faces, where edge-function cancellation
    makes the pick sensitive to rounding): f32 inputs promote exactly to
    f64, where 24-bit products are exact, so this map follows the true
    geometry.  Not a bit-parity target for f32 backends.

    Returns face_index [H, W] int32 (-1 background).
    """
    lib = _load()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    face_index = np.empty((height, width), np.int32)
    lib.dirt_oracle_visibility_f64(_fptr(vertices), _iptr(faces),
                                   vertices.shape[0], faces.shape[0],
                                   height, width, _iptr(face_index))
    return face_index


def rasterise_clipped(background, vertices, vertex_colors, faces):
    """Rasterises one image with the GL polygon-clipping oracle.

    The independent ground truth for w <= 0: Sutherland-Hodgman clipping
    against {w >= eps, -w <= z <= w}, then projected 2-D rasterisation, as
    GL hardware does.  Coverage may differ from the per-fragment backends
    only in a one-pixel band at region boundaries.  Up to 8 channels.

    Returns (pixels [H, W, C] float32, face_index [H, W] int32).
    """
    channels = np.shape(background)[-1]
    if channels > 8:
        raise ValueError(f"the clipped oracle supports up to 8 channels, "
                         f"not {channels}")
    return _rasterise_with(_load().dirt_oracle_rasterise_clipped, background,
                           vertices, vertex_colors, faces)
