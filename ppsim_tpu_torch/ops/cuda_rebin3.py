"""Axis-factorized 3D rebin: the Hopper kernels K4 (x and z passes) and K5
(y pass) and their plain twins (port of :mod:`ppsim_tpu.ops.pallas_rebin3`).

:func:`rebin3_inplane_cuda` and :func:`rebin3_ypass_cuda` launch
``csrc/rebin3.cu`` on CUDA tensors and run :func:`rebin3_inplane_plain` and
:func:`rebin3_ypass_plain` (``grid3d_ops._axis_pass``) on CPU tensors; a
tensor on any other device raises. Count planes are int32:

- K4 returns ``(Slab3State, counts)`` with ``counts`` the (5, Y, X, Z) stack
  ``[m-, alive, m+, far_pre, alive_pre]``: the y pass's acceptance inputs of
  the xz-settled slab, then the pre-rebin monitor planes;
- K5 returns ``(Slab3State, post)`` with ``post`` the (2, Y, X, Z) stack
  ``[alive_post, resid]``.

:func:`grid3_rebin_cuda` chains them and sums the monitors in int64, so it
has the contract of ``grid3d_ops.grid3_rebin_axes`` (bitwise).

K4 settles the x pass and the z pass in one launch through shared-memory
tiles (``csrc/rebin_tile.cuh``, as K2): :func:`rebin3_plan` gives its launch
plan from the geometry alone, and the entry point refuses any other.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.cuda_grid import (
    MAX_CAP, TILE_THREADS, TilePlan, _check_planes, segment,
)
from ppsim_tpu_torch.ops.cuda_rebin import rebin_smem, strip_tile
from ppsim_tpu_torch.ops.grid3d_ops import (
    Geometry3S, Slab3State, _axis_pass, post_counts, rebin3_monitors, slab3_dirs,
    y_counts,
)
from ppsim_tpu_torch.ops.grid_ops import f32

__all__ = ["rebin3_inplane_cuda", "rebin3_inplane_plain", "rebin3_ypass_cuda",
           "rebin3_ypass_plain", "grid3_rebin_cuda", "rebin3_plan"]

# Count-plane indices of K4's stack.
M_MINUS, ALIVE, M_PLUS, FAR_PRE, ALIVE_PRE = range(5)
# Strip widths (z-bins) of K4, widest first: the plan takes the first whose
# block leaves room for two blocks on an SM (32 up to capacity 22).
_TILES3 = (32, 16)


def rebin3_plan(shape) -> TilePlan:
    """K4 launch plan for slab planes of ``shape`` = (cap, Y, X, Z): strips
    of up to 32 z-bins of one y-slab, walked along x in segments
    (``cuda_grid.segment``); blocks in the order (y, segment, strip), strips
    fastest. The kernel takes a ragged last strip."""
    cap, Y, X, Z = shape
    t = strip_tile(lambda t: rebin_smem(7, cap, t), Z, _TILES3)
    tiles = -(-Z // t) * Y
    seg = segment(X, tiles)
    return TilePlan((t,), seg, TILE_THREADS, tiles * -(-X // seg), rebin_smem(7, cap, t))


def rebin3_inplane_plain(state: Slab3State, geom: Geometry3S, evac_cap: int):
    """Plain twin of K4: the pre-rebin monitor planes, the x pass, the z
    pass, and the y counts of the result."""
    i32 = torch.int32
    _, _, _, far, alive = slab3_dirs(state, geom)
    pre = torch.stack([far.sum(dim=0, dtype=i32), alive.sum(dim=0, dtype=i32)])
    for axis in (1, 2):
        state = _axis_pass(state, geom, evac_cap, axis)
    return state, torch.cat([y_counts(state, geom), pre])


def rebin3_ypass_plain(state: Slab3State, counts, geom: Geometry3S,
                       evac_cap: int):
    """Plain twin of K5: the y pass and the post-rebin monitor planes (the
    acceptance inputs are recomputed from the fields; ``counts`` is K5's
    copy of them)."""
    state = _axis_pass(state, geom, evac_cap, 0)
    return state, post_counts(state, geom)


def _check_slab(state: Slab3State, geom: Geometry3S) -> None:
    _check_planes(state[:6], geom.shape)
    _check_planes(state[6:], geom.shape, dtype=torch.int32)
    if geom.capacity > MAX_CAP:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAP}, the kernel's largest")


def _geom_args(geom: Geometry3S):
    cap, Y, X, Z = geom.shape
    return (cap, Y, X, Z, geom.ys, geom.xs, geom.zs)


def rebin3_inplane_cuda(state: Slab3State, geom: Geometry3S, evac_cap: int):
    """K4 on CUDA tensors (``rebin3_inplane_cuda.launches`` counts the
    launches, one a call); the plain twin on CPU tensors. The output slab and
    the count planes are fresh buffers; the input slab is left untouched."""
    if state.xl.device.type == "cpu":
        return rebin3_inplane_plain(state, geom, evac_cap)
    _check_slab(state, geom)
    dev = state.xl.device
    plan = rebin3_plan(geom.shape)
    out = Slab3State(*(torch.empty_like(t) for t in state))
    counts = torch.empty((5, *geom.shape[1:]), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    err = lib.ppsim_rebin3_inplane(
        *(t.data_ptr() for t in (*state, *out, counts)),
        dev.index, *_geom_args(geom), evac_cap, *plan.tile, plan.seg,
        plan.threads, plan.blocks, plan.smem, f32(geom.bsx), f32(geom.bsz),
        f32(1.0 / geom.bsx), f32(1.0 / geom.bsy), f32(1.0 / geom.bsz),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "rebin3_inplane kernel")
    rebin3_inplane_cuda.launches += 1
    return out, counts


rebin3_inplane_cuda.launches = 0


def rebin3_ypass_cuda(state: Slab3State, counts, geom: Geometry3S,
                      evac_cap: int):
    """K5 on CUDA tensors (``rebin3_ypass_cuda.launches`` counts the
    launches); the plain twin on CPU tensors. ``counts`` is K4's stack (its
    first two planes are read)."""
    if state.xl.device.type == "cpu":
        return rebin3_ypass_plain(state, counts, geom, evac_cap)
    _check_slab(state, geom)
    _check_planes((counts,), (5, *geom.shape[1:]), dtype=torch.int32)
    dev = state.xl.device
    out = Slab3State(*(torch.empty_like(t) for t in state))
    post = torch.empty((2, *geom.shape[1:]), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    err = lib.ppsim_rebin3_ypass(
        *(t.data_ptr() for t in (*state, counts, *out, post)),
        dev.index, *_geom_args(geom), evac_cap, f32(geom.bsy),
        f32(1.0 / geom.bsx), f32(1.0 / geom.bsy), f32(1.0 / geom.bsz),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "rebin3_ypass kernel")
    rebin3_ypass_cuda.launches += 1
    return out, post


rebin3_ypass_cuda.launches = 0


def grid3_rebin_cuda(state: Slab3State, geom: Geometry3S, evac_cap: int):
    """Single-device 3D rebin: K4, K5 and the monitors, summed in int64 (a
    float32 sum loses integer exactness past 2^24, below 20.97M); the
    contract of ``grid3d_ops.grid3_rebin_axes``."""
    mid, counts = rebin3_inplane_cuda(state, geom, evac_cap)
    new, post = rebin3_ypass_cuda(mid, counts, geom, evac_cap)
    return new, rebin3_monitors(counts[FAR_PRE], counts[ALIVE_PRE], post)
