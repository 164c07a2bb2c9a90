"""ctypes bindings to the native (C++) scene-builder kernels.

The reference's scene generator is native C++ (`owHelper.cpp`); this module
loads ``native/libsphscene.so`` (built with ``make -C native``, or on demand
here) and exposes the heavy emission loops and the cell-binned spring-graph
search. Every entry point has a pure-NumPy fallback in
:mod:`sph_jax.scene.worm`; the library is compiled with ``-ffp-contract=off``
so both paths produce bitwise-identical float32 scenes (tested).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsphscene.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sph_pool_liquid.restype = ctypes.c_int64
    lib.sph_pool_liquid.argtypes = [ctypes.c_float] * 5 + [
        f32p, ctypes.c_int64]
    lib.sph_boundary_box.restype = ctypes.c_int64
    lib.sph_boundary_box.argtypes = [ctypes.c_float] * 4 + [
        f32p, f32p, ctypes.c_int64]
    lib.sph_inner_worm_liquid.restype = ctypes.c_int64
    lib.sph_inner_worm_liquid.argtypes = [ctypes.c_float] * 4 + [
        f32p, ctypes.c_int64]
    lib.sph_spring_graph.restype = ctypes.c_int64
    lib.sph_spring_graph.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, i32p, f32p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pool_liquid(r0, x_max, y_max, z_max, fill):
    lib = _load()
    n = lib.sph_pool_liquid(r0, x_max, y_max, z_max, fill, None, 0)
    out = np.empty((n, 3), np.float32)
    lib.sph_pool_liquid(r0, x_max, y_max, z_max, fill, _fp(out), n)
    return out


def boundary_box(r0, x_max, y_max, z_max):
    lib = _load()
    n = lib.sph_boundary_box(r0, x_max, y_max, z_max, None, None, 0)
    pos = np.empty((n, 3), np.float32)
    nrm = np.empty((n, 3), np.float32)
    lib.sph_boundary_box(r0, x_max, y_max, z_max, _fp(pos), _fp(nrm), n)
    return pos, nrm


def inner_worm_liquid(r0, x_max, y_max, z_max):
    lib = _load()
    n = lib.sph_inner_worm_liquid(r0, x_max, y_max, z_max, None, 0)
    out = np.empty((n, 3), np.float32)
    lib.sph_inner_worm_liquid(r0, x_max, y_max, z_max, _fp(out), n)
    return out


def spring_graph(pos, n_elastic, n_liquid, r0, scale, max_n):
    """Returns (idx [Ne,max_n] i32 -1-padded, rest [Ne,max_n] f32)."""
    lib = _load()
    pos = np.ascontiguousarray(pos, np.float32)
    idx = np.full((n_elastic, max_n), -1, np.int32)
    rest = np.zeros((n_elastic, max_n), np.float32)
    lib.sph_spring_graph(
        _fp(pos), len(pos), n_elastic, n_liquid,
        np.float32(r0), np.float32(scale), max_n,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fp(rest),
    )
    return idx, rest
