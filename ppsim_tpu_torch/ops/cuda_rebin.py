"""Slab rebin kernels and their plain twins (port of
:mod:`ppsim_tpu.ops.pallas_rebin`, which holds both rebin modes).

``axes`` (the default): :func:`rebin_axes_call_cuda` launches K2
(``csrc/rebin_axes.cu``: x pass, then y pass, two launches through an
x-settled scratch slab); plain twin :func:`rebin_axes_call_plain`
(``grid_ops.rebin_axes_planes``). Both return ``(SlabState, cnt)`` and decide
every move exactly as ``grid_ops.grid_rebin_axes`` does (bitwise).

``dirs9`` (the ablation): :func:`rebin_counts_cuda` launches K7 and
:func:`rebin_shuffle_cuda` K8 (``csrc/rebin_dirs9.cu``); plain twins
:func:`rebin_counts_plain` (``grid_ops.rebin_counts``) and
:func:`rebin_shuffle_plain` (``grid_ops.rebin_shuffle``). They decide every
move exactly as ``grid_ops.grid_rebin`` does (bitwise).

``cnt`` is the int32 (4, R, C) monitor stack ``[far_pre, alive_pre,
alive_post, resid]`` in both modes (``grid_ops.monitor_planes``), so
:func:`grid_rebin_cuda` reports the monitors of the JAX package's
``grid_rebin_pallas``: ``deferred`` counts the live slots that still point
out of their bin after the shuffle (``grid_ops.grid_rebin`` counts the
rejected leavers before it instead). On CUDA tensors a wrapper launches its
kernel; on CPU tensors it runs the plain twin; any other device raises.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.cuda_grid import MAX_CAP, _check_planes
from ppsim_tpu_torch.ops.grid_ops import (
    SlabGeometry, SlabState, f32, monitor_planes, monitors_of_counts,
    rebin_axes_planes as rebin_axes_call_plain, rebin_counts, rebin_shuffle,
)

__all__ = ["rebin_axes_call_cuda", "rebin_axes_call_plain", "grid_rebin_axes_cuda",
           "rebin_counts_cuda", "rebin_counts_plain", "rebin_shuffle_cuda",
           "rebin_shuffle_plain", "grid_rebin_cuda"]


def _check_slab(state: SlabState, geom: SlabGeometry) -> None:
    _check_planes(state[:4], geom.shape)
    _check_planes(state[4:], geom.shape, dtype=torch.int32)
    if geom.capacity > MAX_CAP:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAP}, the kernel's largest")


def rebin_axes_call_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int):
    """K2 on CUDA tensors (``rebin_axes_call_cuda.launches`` counts calls,
    each of which launches both passes); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_axes_call_plain(state, geom, evac_cap)
    _check_slab(state, geom)
    cap, R, C = geom.shape
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


def rebin_counts_plain(state: SlabState, geom: SlabGeometry):
    """Plain twin of K7: the int32 (9, R, C) dirs9 count stack."""
    return rebin_counts(state, geom)[0]


def rebin_shuffle_plain(state: SlabState, counts, geom: SlabGeometry, evac_cap: int):
    """Plain twin of K8: ``(SlabState, cnt)``, the shuffled slab and its
    monitor planes."""
    new, _ = rebin_shuffle(state, counts, geom, evac_cap)
    return new, monitor_planes(state, new, geom)


def rebin_counts_cuda(state: SlabState, geom: SlabGeometry):
    """K7 on CUDA tensors (``rebin_counts_cuda.launches`` counts the
    launches); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_counts_plain(state, geom)
    _check_slab(state, geom)
    cap, R, C = geom.shape
    counts = torch.empty((9, R, C), dtype=torch.int32, device=state.xl.device)
    err = _build.kernels().ppsim_rebin_counts(
        state.xl.data_ptr(), state.yl.data_ptr(), state.pid.data_ptr(),
        counts.data_ptr(), state.xl.device.index, cap, R, C, geom.rows,
        geom.cols, f32(1.0 / geom.bin_size),
        torch.cuda.current_stream(state.xl.device).cuda_stream)
    _build.check_launch(err, "rebin_counts kernel")
    rebin_counts_cuda.launches += 1
    return counts


rebin_counts_cuda.launches = 0


def rebin_shuffle_cuda(state: SlabState, counts, geom: SlabGeometry, evac_cap: int):
    """K8 on CUDA tensors (``rebin_shuffle_cuda.launches`` counts the
    launches); the plain twin on CPU tensors. The output slab and the monitor
    planes are fresh buffers; the input slab is left untouched."""
    if state.xl.device.type == "cpu":
        return rebin_shuffle_plain(state, counts, geom, evac_cap)
    _check_slab(state, geom)
    cap, R, C = geom.shape
    _check_planes((counts,), (9, R, C), dtype=torch.int32)
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    err = _build.kernels().ppsim_rebin_shuffle(
        *(t.data_ptr() for t in (*state, counts, *out, cnt)),
        state.xl.device.index, cap, R, C, geom.rows, geom.cols, evac_cap,
        f32(geom.bin_size), f32(1.0 / geom.bin_size),
        torch.cuda.current_stream(state.xl.device).cuda_stream)
    _build.check_launch(err, "rebin_shuffle kernel")
    rebin_shuffle_cuda.launches += 1
    return out, cnt


rebin_shuffle_cuda.launches = 0


def grid_rebin_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int):
    """Single-device 9-direction rebin: K7 + K8 plus the monitors of the JAX
    package's ``grid_rebin_pallas``, reduced on the device (int64 sums, no
    host wait)."""
    counts = rebin_counts_cuda(state, geom)
    new, cnt = rebin_shuffle_cuda(state, counts, geom, evac_cap)
    return new, monitors_of_counts(cnt)
