"""ctypes bindings for the native runtime (libvoxelnative.so).

Builds on demand with `make` (g++, no external deps) when the library is
missing or older than voxelnative.cpp; every entry point has a
pure-Python fallback, so the package works without a toolchain.

  parse_obj_native(path)          fast OBJ positions+faces parse
  voxelize_native(...)            serial oracle voxelizer at native speed
  morton_encode_native(x, y, z)   63-bit Morton codes
  build_octree_nodes_native(...)  pre-order flat node array
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_DIR, "voxelnative.cpp")
_LIB_PATH = os.path.join(_DIR, "libvoxelnative.so")
_lib = None
_tried = False


def _stale(src=_SRC_PATH, lib=_LIB_PATH) -> bool:
    """The library is missing or older than its source."""
    return (not os.path.exists(lib)
            or os.path.getmtime(src) > os.path.getmtime(lib))


def _build() -> bool:
    """make the library into a private file, then rename it into place:
    processes importing this module at once never load a half-written
    library."""
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _DIR, f"LIB={os.path.basename(tmp)}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    c_long = ctypes.c_long
    lib.parse_obj.restype = ctypes.c_int
    lib.parse_obj.argtypes = [
        ctypes.c_char_p, c_long,
        ctypes.c_void_p, ctypes.POINTER(c_long),
        ctypes.c_void_p, ctypes.POINTER(c_long),
    ]
    lib.voxelize.restype = c_long
    lib.voxelize.argtypes = [
        ctypes.c_void_p, c_long, ctypes.c_void_p, c_long,
        ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.morton_encode.restype = None
    lib.morton_encode.argtypes = [ctypes.c_void_p] * 3 + [c_long,
                                                          ctypes.c_void_p]
    lib.sort_u64.restype = None
    lib.sort_u64.argtypes = [ctypes.c_void_p, c_long]
    lib.build_octree_nodes.restype = c_long
    lib.build_octree_nodes.argtypes = [
        ctypes.c_void_p, c_long, ctypes.c_int, c_long,
        ctypes.c_void_p, c_long,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_obj_native(path: str):
    """(vertices (V,3) f32, faces (F,3) i32) or None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        text = fh.read()
    nv = ctypes.c_long(0)
    nf = ctypes.c_long(0)
    lib.parse_obj(text, len(text), None, ctypes.byref(nv), None,
                  ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.parse_obj(text, len(text), _ptr(verts), ctypes.byref(nv),
                  _ptr(faces), ctypes.byref(nf))
    return verts, faces


def voxelize_native(vertices, faces, voxel_size, bb_min, dims):
    """(occ (Z,Y,X) uint8, set_calls) or None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    bb = np.ascontiguousarray(bb_min, np.float32)
    nx, ny, nz = dims
    occ = np.zeros((nz, ny, nx), np.uint8)
    calls = lib.voxelize(_ptr(v), len(v), _ptr(f), len(f),
                         ctypes.c_float(voxel_size), _ptr(bb),
                         nx, ny, nz, _ptr(occ))
    return occ, int(calls)


def morton_encode_native(x, y, z):
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    out = np.empty(len(x), np.uint64)
    lib.morton_encode(_ptr(x), _ptr(y), _ptr(z), len(x), _ptr(out))
    return out


def sort_codes_native(codes):
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, np.uint64).copy()
    lib.sort_u64(_ptr(c), len(c))
    return c


def build_octree_nodes_native(codes_sorted, max_depth, max_items):
    """(M, 10) int64 node rows, or None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes_sorted, np.uint64)
    cap = max(1, 2 * len(c) + 8)
    nodes = np.empty((cap, 10), np.int64)
    n = lib.build_octree_nodes(_ptr(c), len(c), int(max_depth),
                               int(max_items), _ptr(nodes), cap)
    if n < 0:
        return None
    return nodes[:n].copy()
