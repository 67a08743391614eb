"""ctypes bindings for the native (C++) runtime library.

The port's copy of ``openhyperflow2d_tpu/geometry/native.py``.  It loads
the repository's ``native/libhf2d_native.so``; when that file is missing or
does not load, it compiles ``native/hf2d_native.cpp`` with the host C++
compiler (the flags of ``native/Makefile``) into ``build/hf2d_torch/native/``
and loads that.  It never writes into ``native/``.  When neither works,
``available()`` is False and the geometry code takes its numpy path, which
gives the same bits, only slower (``geometry/wall.py``).

``SOURCE`` records which library was loaded: "prebuilt", "built" or None.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
PREBUILT = REPO / "native" / "libhf2d_native.so"
CPP_SOURCE = REPO / "native" / "hf2d_native.cpp"
BUILD_DIR = REPO / "build" / "hf2d_torch" / "native"
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
            "-std=c++17", "-Wall", "-shared"]

_LIB = None
_TRIED = False
SOURCE = None


def _open(path: Path):
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


def _build():
    """Compile the library into BUILD_DIR; returns its path or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not CPP_SOURCE.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libhf2d_native.so"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(out), str(CPP_SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load():
    global _LIB, _TRIED, SOURCE
    if _TRIED:
        return _LIB
    _TRIED = True
    lib = _open(PREBUILT) if PREBUILT.exists() else None
    SOURCE = "prebuilt" if lib is not None else None
    if lib is None:
        built = _build()
        lib = _open(built) if built is not None else None
        SOURCE = "built" if lib is not None else None
    if lib is None:
        return None
    lib.hf2d_flood_fill.restype = ctypes.c_int64
    lib.hf2d_flood_fill.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.hf2d_min_wall_distance.restype = None
    lib.hf2d_min_wall_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _pf(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def flood_fill(unset: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """Native 4-connected flood fill; returns bool region mask."""
    lib = _load()
    X, Y = unset.shape
    u8 = np.ascontiguousarray(unset, np.uint8)
    out = np.zeros((X, Y), np.uint8)
    r = lib.hf2d_flood_fill(_p8(u8), _p8(out), X, Y, sx, sy)
    if r < 0:
        raise ValueError(f"flood fill failed at seed ({sx},{sy}): {r}")
    return out.astype(bool)


def min_wall_distance(wall_nodes: np.ndarray, active: np.ndarray,
                      dx: float, dy: float, x0: float, l_init: float):
    """Native nearest-wall transform (reference tie-break semantics).
    Returns (l_min, i_wall, j_wall) for active nodes (others zero)."""
    lib = _load()
    X, Y = active.shape
    wi = np.ascontiguousarray(wall_nodes[:, 0], np.int32)
    wj = np.ascontiguousarray(wall_nodes[:, 1], np.int32)
    act = np.ascontiguousarray(active, np.uint8)
    l_min = np.zeros((X, Y), np.float64)
    i_wall = np.zeros((X, Y), np.int32)
    j_wall = np.zeros((X, Y), np.int32)
    lib.hf2d_min_wall_distance(_p32(wi), _p32(wj), len(wi), _p8(act),
                               X, Y, dx, dy, x0, l_init,
                               _pf(l_min), _p32(i_wall), _p32(j_wall))
    return l_min, i_wall, j_wall
