"""Slab rebin kernels and their plain twins (port of
:mod:`ppsim_tpu.ops.pallas_rebin`, which holds both rebin modes).

``axes`` (the default): :func:`rebin_axes_call_cuda` launches K2
(``csrc/rebin_axes.cu``: the x pass, then the y pass, in one launch through
shared-memory tiles, ``csrc/rebin_tile.cuh``); plain twin
:func:`rebin_axes_call_plain` (``grid_ops.rebin_axes_planes``). Both return
``(SlabState, cnt)`` and decide every move exactly as
``grid_ops.grid_rebin_axes`` does (bitwise). :func:`rebin_plan` gives K2's
launch plan from the geometry alone and :func:`rebin_smem` repeats the
kernel's shared-memory layout (K4's ``cuda_rebin3.rebin3_plan`` too); the
entry point refuses any other plan.

``dirs9`` (the ablation): :func:`rebin_counts_cuda` launches K7 and
:func:`rebin_shuffle_cuda` K8 (``csrc/rebin_dirs9.cu``; K8 walks strips
through shared memory as K2 does, on the plan :func:`shuffle_plan`, whose
:func:`shuffle_smem` repeats the kernel's layout); plain twins
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
from ppsim_tpu_torch.ops.cuda_grid import (
    MAX_CAP, SMEM_TWO_BLOCKS, TILE_THREADS, TilePlan, _align16, _check_planes, segment,
)
from ppsim_tpu_torch.ops.grid_ops import (
    SlabGeometry, SlabState, f32, monitor_planes, monitors_of_counts,
    rebin_axes_planes as rebin_axes_call_plain, rebin_counts, rebin_shuffle,
)

__all__ = ["rebin_axes_call_cuda", "rebin_axes_call_plain", "grid_rebin_axes_cuda",
           "rebin_counts_cuda", "rebin_counts_plain", "rebin_shuffle_cuda",
           "rebin_shuffle_plain", "grid_rebin_cuda", "rebin_plan", "rebin_smem",
           "shuffle_plan", "shuffle_smem", "strip_tile"]

# Buffers in the fused rebin's ring (csrc/rebin_tile.cuh kRebinRing): the
# rows w-1..w+2 that settle row w and the one in flight.
_REBIN_RING = 5
# Strip widths of K2 and K8, widest first: the plan takes the first whose
# block leaves room for two blocks on an SM (K2: 32 up to capacity 30).
# Strips of 32 columns, with cuda_grid.segment's rows, ran as fast as the
# fastest plan tried for K2 on the H100 (PERF.md).
_TILES2 = (32, 16)
# K8's rings (csrc/rebin_dirs9.cu): the field rows r-1..r+1 and the count
# rows r-2..r+2 that settle row r, one more of each in flight, and the off
# tables of rows r-1..r+1; each field-buffer bin keeps 10 words of masks.
_SHUFFLE_RINGS = (4, 6, 3)
_SHUFFLE_MASK_WORDS = 10


def rebin_smem(nfields: int, cap: int, tile: int) -> int:
    """Shared-memory bytes of a fused rebin block (``csrc/rebin_tile.cuh``
    rebin_layout) with a strip of ``tile`` own bins and ``nfields`` planes
    (5 in 2D, 7 in 3D): the ring of input rows over the strip and its halo
    (1 bin before, 2 after) with their six masks, the walked pass's source map,
    the settled row's masks, the final source map and the monitor counters."""
    hb = tile + 3
    buf = _align16(nfields * cap * hb * 4) + _align16(6 * hb * 4)
    return (_REBIN_RING * buf + _align16(cap * hb) + _align16(3 * hb * 4)
            + _align16(2 * cap * tile) + 2 * tile * 4)


def shuffle_smem(cap: int, tile: int) -> int:
    """Shared-memory bytes of a K8 block (``csrc/rebin_dirs9.cu``
    shuffle_layout) with a strip of ``tile`` own bins: the ring of field rows
    (5 planes over the strip and 1 bin each side, with their masks), of count
    rows (9 planes, 2 bins each side) and of off tables (8 directions, 1 bin
    each side), then the final source map and the monitor counters."""
    nf, nc, no = _SHUFFLE_RINGS
    hf, hc = tile + 2, tile + 4
    fbuf = _align16(5 * cap * hf * 4) + _align16(_SHUFFLE_MASK_WORDS * hf * 4)
    return (nf * fbuf + nc * _align16(9 * hc * 4) + _align16(no * 8 * hf * 4)
            + _align16(2 * cap * tile) + 4 * tile * 4)


def strip_tile(smem_of, extent: int, tiles) -> int:
    """The widest strip of ``tiles`` whose block (``smem_of(tile)`` bytes)
    fits two on an SM (else the narrowest), no wider than the strip axis'
    ``extent``."""
    for tile in tiles:
        if smem_of(tile) <= SMEM_TWO_BLOCKS:
            break
    return min(tile, extent)


def rebin_plan(shape) -> TilePlan:
    """K2 launch plan for slab planes of ``shape`` = (cap, R, C): strips of
    32 columns (16 at capacities above 30), segments of rows
    (``cuda_grid.segment``). The kernel takes a ragged last strip."""
    cap, R, C = shape
    t = strip_tile(lambda t: rebin_smem(5, cap, t), C, _TILES2)
    strips = -(-C // t)
    seg = segment(R, strips)
    return TilePlan((t,), seg, TILE_THREADS, strips * -(-R // seg), rebin_smem(5, cap, t))


def shuffle_plan(shape) -> TilePlan:
    """K8 launch plan for slab planes of ``shape`` = (cap, R, C): strips of
    32 columns (16 where a block would not leave room for two on an SM),
    segments of rows (``cuda_grid.segment``), one thread per (own bin,
    direction) at least. The kernel takes a ragged last strip."""
    cap, R, C = shape
    t = strip_tile(lambda t: shuffle_smem(cap, t), C, _TILES2)
    strips = -(-C // t)
    seg = segment(R, strips)
    return TilePlan((t,), seg, TILE_THREADS, strips * -(-R // seg), shuffle_smem(cap, t))


def _check_slab(state: SlabState, geom: SlabGeometry) -> None:
    _check_planes(state[:4], geom.shape)
    _check_planes(state[4:], geom.shape, dtype=torch.int32)
    if geom.capacity > MAX_CAP:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAP}, the kernel's largest")


def rebin_axes_call_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int):
    """K2 on CUDA tensors (``rebin_axes_call_cuda.launches`` counts the
    launches, one a call); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_axes_call_plain(state, geom, evac_cap)
    _check_slab(state, geom)
    cap, R, C = geom.shape
    plan = rebin_plan(geom.shape)
    # The output slab and the count planes are fresh buffers; the input slab
    # is left untouched.
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    lib = _build.kernels()
    err = lib.ppsim_rebin_axes(
        *(t.data_ptr() for t in (*state, *out, cnt)),
        state.xl.device.index, cap, R, C, geom.rows, geom.cols, evac_cap,
        *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem,
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
    plan = shuffle_plan(geom.shape)
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    err = _build.kernels().ppsim_rebin_shuffle(
        *(t.data_ptr() for t in (*state, counts, *out, cnt)),
        state.xl.device.index, cap, R, C, geom.rows, geom.cols, evac_cap,
        *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem,
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
