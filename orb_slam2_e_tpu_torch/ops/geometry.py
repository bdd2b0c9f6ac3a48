"""Host geometry of the deformable mode: Delaunay triangulation and nearest
neighbours, in C++ behind ctypes.

Port of the geometry half of `orb_slam2_e_tpu/native/__init__.py`.
`csrc/geometry.cpp` is this package's copy of the reference's source, built
by g++ at first use into `build/` beside this package (`.gitignore` lists
it) under a name hashed from the source and the flags, as `ops/kernels.py`
builds the CUDA kernel.

Divergence from the reference: there is ONE triangulator. The reference
falls back to scipy's Qhull when its library is missing; Bowyer-Watson and
Qhull pick different diagonals on co-circular points (every regular grid),
a different mesh is a different strain energy, and so the same frame would
relocalize differently from one machine to the next. Here a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "geometry.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
# the reference's flags (orb_slam2_e_tpu/native/__init__.py): the in-circle
# test is f64 arithmetic whose contraction into fused multiply-adds follows
# the flags, and equal triangles need equal arithmetic
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


class _Lib:
    handle = None


def build() -> ctypes.CDLL:
    """Compile csrc/geometry.cpp (once per source hash) and load it."""
    if _Lib.handle is not None:
        return _Lib.handle
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    so_path = os.path.join(_BUILD_DIR, f"libgeometry_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.remove(tmp)
            raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, so_path)     # never a half-written library
    lib = ctypes.CDLL(so_path)
    fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.delaunay_triangulate.restype = ctypes.c_int
    lib.delaunay_triangulate.argtypes = [fptr, ctypes.c_int, iptr,
                                         ctypes.c_int]
    lib.knn_query.restype = None
    lib.knn_query.argtypes = [fptr, ctypes.c_int, fptr, ctypes.c_int,
                              ctypes.c_int, ctypes.c_float, iptr]
    _Lib.handle = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def delaunay(points_xy: np.ndarray) -> np.ndarray:
    """2D Delaunay triangulation (Bowyer-Watson): (N, 2) -> (T, 3) int32
    counter-clockwise triangles, T = 0 below three points."""
    pts = np.ascontiguousarray(points_xy, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"expected (N, 2) points, got {pts.shape}")
    n = len(pts)
    max_tris = 4 * n + 16            # a triangulation has fewer than 2n
    out = np.empty((max_tris, 3), np.int32)
    cnt = build().delaunay_triangulate(_fptr(pts), n, _iptr(out), max_tris)
    if cnt < 0:
        raise RuntimeError("delaunay_triangulate overflowed its output")
    return out[:cnt].copy()


def knn(points: np.ndarray, queries: np.ndarray, k: int,
        cell: float = 0.5) -> np.ndarray:
    """Grid-hash nearest neighbours: (N, 3) points, (M, 3) queries -> (M, k)
    int32 indices into `points`, nearest first, -1 where fewer than k lie
    within four cells."""
    pts = np.ascontiguousarray(points, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or q.ndim != 2 or q.shape[1] != 3:
        raise ValueError(f"expected (N, 3) and (M, 3), got {pts.shape} and "
                         f"{q.shape}")
    if k < 1 or not cell > 0:
        raise ValueError(f"k={k} and cell={cell} must be positive")
    out = np.empty((len(q), k), np.int32)
    build().knn_query(_fptr(pts), len(pts), _fptr(q), len(q), k,
                      ctypes.c_float(cell), _iptr(out))
    return out
