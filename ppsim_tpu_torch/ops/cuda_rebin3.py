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

Shards (the sharded engine, ``engines/sharded_grid3d.py``): every wrapper
and twin takes ``y0``, the global index of the planes' first y slab. K4's
passes are slab-local, so it takes nothing else. K5 takes the neighbouring
shards' ghost slabs of K4's output: ``field_ghosts``, a (top, bot) pair per
field in (xl, yl, zl, vx, vy, vz, pid) order, each (cap, 1, X, Z), and
``count_ghosts``, the (top, bot) pair of K4's first two count planes [m-,
alive], (2, 1, X, Z) and (2, 2, X, Z): the slabs it reads beyond each edge.

K4 settles the x pass and the z pass in one launch through shared-memory
tiles (``csrc/rebin_tile.cuh``, as K2): :func:`rebin3_plan` gives its launch
plan from the geometry alone, and the entry point refuses any other.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.cuda_grid import (
    MAX_CAP, TILE_THREADS, TilePlan, _check_planes, _ptrs, check_ghosts, segment,
)
from ppsim_tpu_torch.ops.cuda_grid3 import slab3_shape
from ppsim_tpu_torch.ops.cuda_rebin import rebin_smem, strip_tile
from ppsim_tpu_torch.ops.grid3d_ops import (
    FILLS3, Geometry3S, Slab3State, _axis_pass, post_counts, rebin3_monitors,
    slab3_dirs, y_counts,
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


def rebin3_inplane_plain(state: Slab3State, geom: Geometry3S, evac_cap: int,
                         y0=0):
    """Plain twin of K4: the pre-rebin monitor planes, the x pass, the z
    pass, and the y counts of the result (``y0``: the global index of the
    first y slab)."""
    i32 = torch.int32
    _, _, _, far, alive = slab3_dirs(state, geom, y0)
    pre = torch.stack([far.sum(dim=0, dtype=i32), alive.sum(dim=0, dtype=i32)])
    for axis in (1, 2):
        state = _axis_pass(state, geom, evac_cap, axis, y0)
    return state, torch.cat([y_counts(state, geom, y0), pre])


def _both_ghosts(field_ghosts, count_ghosts) -> bool:
    if (field_ghosts is None) != (count_ghosts is None):
        raise ValueError("K5's shard form takes field and count ghosts together")
    return field_ghosts is not None


def rebin3_ypass_plain(state: Slab3State, counts, geom: Geometry3S,
                       evac_cap: int, y0=0, field_ghosts=None, count_ghosts=None):
    """Plain twin of K5: the y pass and the post-rebin monitor planes (the
    acceptance inputs are recomputed from the fields; ``counts`` is K5's
    copy of them). With ghosts (both kinds or neither), the pass runs on the
    fields extended by the ghost slab each side and an empty slab below it,
    with the -1 movers of the slab two below the planes taken from the
    count ghosts (the one input of the pass beyond the field ghosts); the
    interior is kept. The extension's edge slabs are read only by the ghost
    slabs' own decisions, which the interior never reads."""
    if not _both_ghosts(field_ghosts, count_ghosts):
        state = _axis_pass(state, geom, evac_cap, 0, y0)
        return state, post_counts(state, geom, y0)
    Y = state.xl.shape[1]
    ext = Slab3State(*(
        torch.cat([top, f, bot, torch.full_like(bot, fill)], 1)
        for f, (top, bot), fill in zip(state, field_ghosts, FILLS3)))
    ctop, cbot = count_ghosts
    m_minus = torch.cat([ctop[0], counts[0], cbot[0]])
    new = _axis_pass(ext, geom, evac_cap, 0, y0 - 1, counts_m=m_minus)
    new = Slab3State(*(f[:, 1:Y + 1].contiguous() for f in new))
    return new, post_counts(new, geom, y0)


def _check_slab(state: Slab3State, geom: Geometry3S):
    """The (cap, Y, X, Z) of a checked slab (Y the planes' own slabs)."""
    shape = slab3_shape(geom, state.xl)
    _check_planes(state[:6], shape)
    _check_planes(state[6:], shape, dtype=torch.int32)
    if geom.capacity > MAX_CAP:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAP}, the kernel's largest")
    return shape


def rebin3_inplane_cuda(state: Slab3State, geom: Geometry3S, evac_cap: int,
                        y0=0):
    """K4 on CUDA tensors (``rebin3_inplane_cuda.launches`` counts the
    launches, one a call; ``y0`` != 0 launches its SHARD instance); the plain
    twin on CPU tensors. The output slab and the count planes are fresh
    buffers; the input slab is left untouched."""
    if state.xl.device.type == "cpu":
        return rebin3_inplane_plain(state, geom, evac_cap, y0)
    shape = _check_slab(state, geom)
    cap, Y, X, Z = shape
    dev = state.xl.device
    plan = rebin3_plan(shape)
    out = Slab3State(*(torch.empty_like(t) for t in state))
    counts = torch.empty((5, Y, X, Z), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    err = lib.ppsim_rebin3_inplane(
        *(t.data_ptr() for t in (*state, *out, counts)),
        dev.index, cap, Y, X, Z, int(y0), geom.ys, geom.xs, geom.zs, evac_cap,
        *plan.tile, plan.seg,
        plan.threads, plan.blocks, plan.smem, f32(geom.bsx), f32(geom.bsz),
        f32(1.0 / geom.bsx), f32(1.0 / geom.bsy), f32(1.0 / geom.bsz),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "rebin3_inplane kernel")
    rebin3_inplane_cuda.launches += 1
    return out, counts


rebin3_inplane_cuda.launches = 0


_FIELD_DTYPES = (torch.float32,) * 6 + (torch.int32,)


def rebin3_ypass_cuda(state: Slab3State, counts, geom: Geometry3S,
                      evac_cap: int, y0=0, field_ghosts=None, count_ghosts=None):
    """K5 on CUDA tensors (``rebin3_ypass_cuda.launches`` counts the
    launches; a shard's inputs launch its SHARD instance); the plain twin on
    CPU tensors. ``counts`` is K4's stack (its first two planes are read)."""
    if state.xl.device.type == "cpu":
        return rebin3_ypass_plain(state, counts, geom, evac_cap, y0,
                                  field_ghosts, count_ghosts)
    ghosts = _both_ghosts(field_ghosts, count_ghosts)
    shape = _check_slab(state, geom)
    cap, Y, X, Z = shape
    dev = state.xl.device
    _check_planes((counts,), (5, Y, X, Z), dtype=torch.int32)
    if ghosts:
        tops, bots = zip(*field_ghosts)
        for g in (tops, bots):
            check_ghosts(g, [(cap, 1, X, Z)] * 7, dev, _FIELD_DTYPES)
        check_ghosts(count_ghosts, [(2, 1, X, Z), (2, 2, X, Z)], dev,
                     (torch.int32,) * 2)
        gptrs = (*_ptrs(tops, 7), *_ptrs(bots, 7), *_ptrs(count_ghosts, 2))
    else:
        gptrs = (0,) * 16
    out = Slab3State(*(torch.empty_like(t) for t in state))
    post = torch.empty((2, Y, X, Z), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    err = lib.ppsim_rebin3_ypass(
        *(t.data_ptr() for t in (*state, counts)), *gptrs,
        *(t.data_ptr() for t in (*out, post)),
        dev.index, cap, Y, X, Z, int(y0), geom.ys, geom.xs, geom.zs, evac_cap,
        f32(geom.bsy),
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
