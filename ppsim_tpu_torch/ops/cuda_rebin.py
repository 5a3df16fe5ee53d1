"""Axis-factorized slab rebin: the Hopper kernel K2 and its plain twin (port
of the ``axes`` path of :mod:`ppsim_tpu.ops.pallas_rebin`).

:func:`rebin_axes_call_cuda` launches ``csrc/rebin_axes.cu`` (x pass, then y
pass, two launches through an x-settled scratch slab) on CUDA tensors and
runs the plain twin :func:`rebin_axes_call_plain`
(``grid_ops.rebin_axes_planes``) on CPU tensors; a tensor on any other
device raises. Both return ``(SlabState, cnt)`` with ``cnt`` the int32
(4, R, C) stack ``[far_pre, alive_pre, alive_post, resid]``, and both decide
every move exactly as ``grid_ops.grid_rebin_axes`` does (bitwise).
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.cuda_grid import MAX_CAP, _check_planes
from ppsim_tpu_torch.ops.grid_ops import (
    SlabGeometry, SlabState, f32, monitors_of_counts,
    rebin_axes_planes as rebin_axes_call_plain,
)

__all__ = ["rebin_axes_call_cuda", "rebin_axes_call_plain", "grid_rebin_axes_cuda"]


def rebin_axes_call_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int):
    """K2 on CUDA tensors (``rebin_axes_call_cuda.launches`` counts calls,
    each of which launches both passes); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_axes_call_plain(state, geom, evac_cap)
    _check_planes(state[:4], geom)
    _check_planes(state[4:], geom, dtype=torch.int32)
    cap, R, C = geom.shape
    if cap > MAX_CAP:
        raise ValueError(f"capacity {cap} > {MAX_CAP}, the kernel's largest")
    # The x-settled scratch and the output are fresh buffers; the input slab
    # is left untouched.
    mid = SlabState(*(torch.empty_like(t) for t in state))
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    lib = _build.kernels()
    err = lib.ppsim_rebin_axes(
        *(t.data_ptr() for t in (*state, *mid, *out, cnt)),
        state.xl.device.index, cap, R, C, geom.rows, geom.cols, evac_cap,
        f32(geom.bin_size), f32(1.0 / geom.bin_size),
        torch.cuda.current_stream(state.xl.device).cuda_stream)
    _build.check_launch(err, "rebin_axes kernel")
    rebin_axes_call_cuda.launches += 1
    return out, cnt


rebin_axes_call_cuda.launches = 0


def grid_rebin_axes_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int):
    """Single-device axis-factorized rebin: K2 plus monitors; same contract
    as ``grid_ops.grid_rebin_axes``."""
    new, cnt = rebin_axes_call_cuda(state, geom, evac_cap)
    return new, monitors_of_counts(cnt)
