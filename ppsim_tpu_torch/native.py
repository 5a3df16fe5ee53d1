"""ctypes bindings for the native C++ library (``native/ppsim_native.cpp``),
the port's own loader.

The port uses all four of its entry points: the bit-faithful mt19937
initializer (``ppsim_init_particles``, which makes n = 20.97M initialise in
seconds instead of the Python loop's hours), the cell-list pair statistics
of the checker (``ppsim_frame_stats``), and the float64 engines, brute force
(``ppsim_run_oracle``, the trust anchor of the oracle engine) and binned
(``ppsim_run_cells``). The unchanged source is compiled with ``g++``
into the port's build directory at first use (:mod:`ppsim_tpu_torch._build`);
without a compiler, :func:`available` is False and callers fall back to numpy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ppsim_tpu_torch._build import build_shared

__all__ = ["load", "available", "native_init", "native_frame_stats", "native_run"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "ppsim_native.cpp")

_D = ctypes.POINTER(ctypes.c_double)
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = build_shared(
            "ppsim_native", [_SRC],
            lambda out: ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                         "-o", out],
            timeout=180)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError):  # no compiler, failed build, bad library
        _load_failed = True
        return None
    i64, f64, i32 = ctypes.c_int64, ctypes.c_double, ctypes.c_int
    lib.ppsim_init_particles.argtypes = [_D, _D, _D, _D, i64, f64, i32]
    lib.ppsim_init_particles.restype = None
    lib.ppsim_frame_stats.argtypes = [_D, i64, i32, f64, _D]
    lib.ppsim_frame_stats.restype = None
    for fn in (lib.ppsim_run_oracle, lib.ppsim_run_cells):
        fn.argtypes = [_D, _D, _D, _D, i64, f64, i64, f64, f64, f64, f64]
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def native_init(num_parts: int, size: float, seed: int):
    """Bit-faithful reference initializer; returns float64 (pos, vel), (N, 2)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed?)")
    x, y, vx, vy = (np.empty(num_parts, np.float64) for _ in range(4))
    lib.ppsim_init_particles(_ptr(x), _ptr(y), _ptr(vx), _ptr(vy),
                             num_parts, size, seed)
    return np.stack([x, y], -1), np.stack([vx, vy], -1)


def native_frame_stats(pos: np.ndarray, cutoff: float):
    """(dmin, dsum, dcount) of sub-cutoff pair distances in one (N, dim)
    frame, each unordered pair once; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n, dim = pos.shape
    out = np.empty(3, np.float64)
    lib.ppsim_frame_stats(_ptr(pos), n, dim, cutoff, _ptr(out))
    dmin = float(out[0]) if out[0] < 1e29 else float("inf")
    return dmin, float(out[1]), int(out[2])


def native_run(pos, vel, config, nsteps: int, engine: str = "cells"):
    """``nsteps`` of a native float64 engine, ``"cells"`` (binned) or
    ``"oracle"`` (O(N^2)), each a force pass then the reference's bounce
    loop, from (N, 2) ``pos`` / ``vel``; returns float64 numpy (pos, vel).
    The inputs are copied."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed?)")
    fn = {"oracle": lib.ppsim_run_oracle, "cells": lib.ppsim_run_cells}[engine]
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 2 or vel.shape != pos.shape:
        raise ValueError(f"the native engines are 2D: expected (N, 2) pos/vel, got "
                         f"{pos.shape} / {vel.shape}")
    x, y, vx, vy = (np.ascontiguousarray(a[:, k]) for a in (pos, vel) for k in (0, 1))
    fn(_ptr(x), _ptr(y), _ptr(vx), _ptr(vy), pos.shape[0], config.size, nsteps,
       config.cutoff, config.min_r, config.mass, config.dt)
    return np.stack([x, y], -1), np.stack([vx, vy], -1)
