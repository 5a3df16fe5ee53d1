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

Shard forms (the sharded engine, ``engines/sharded_grid.py``): every
wrapper and twin takes ``row0``, the global row of the planes' first row,
and the rebins take the neighbouring shards' ghost rows, in the JAX
package's layout: ``field_ghosts`` a (top, bot) pair per field in (xl, yl,
vx, vy, pid) order, ``count_ghosts`` one (top, bot) pair of the count stack.
K2 takes 1 row from above for every field and, from below, 2 rows of xl and
pid and 1 of the others (its walk reads masks at rows w-1..w+2 and fields
at w-1..w+1); K8 takes 1 field row each side and 2 count rows each side
(its rings: fields at r-1..r+1, counts at r-2..r+2). The twins run the
single-device twin on the planes extended by the ghost rows and keep the
interior. Without ghosts the call is the single-device one.

Tile forms (the 2-D tile engine, ``engines/sharded_tile.py``): K2's wrapper
and twin also take ``col0``, the global column of the planes' first column,
and ``col_ghosts``, a (west, east) pair per field in the same order: the
last column of the tile to the west and the first two columns of the tile
to the east, cut from the row-extended neighbours, so over rows -1..R+1 for
xl and pid ((cap, R + 3, 1) and (cap, R + 3, 2)) and rows -1..R for the
others ((cap, R + 2, w)). These are the columns K2's walk reads beyond a
tile (its strip pass reads the walk-settled columns c-1..c+2); the JAX
package's pallas route carries 2 a side (``sharded_tile.py:301``). They need
the ghost rows. The count planes cover own bins only. The dirs9 rebin has
no tile form: the tile engine runs it on the torch ops, as the JAX engine
runs it on its XLA route.

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
    MAX_CAP, SMEM_TWO_BLOCKS, TILE_THREADS, TilePlan, _align16, _check_planes, _ptrs,
    check_ghosts, segment, slab_shape,
)
from ppsim_tpu_torch.ops.grid_ops import (
    SLAB_FILLS, SlabGeometry, SlabState, _axis_pass2, f32, monitor_planes, monitors_of_counts,
    rebin_axes_planes, rebin_counts, rebin_shuffle,
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


# The slab fields' types, (xl, yl, vx, vy, pid).
_FIELD_DTYPES = (torch.float32,) * 4 + (torch.int32,)


def _check_slab(state: SlabState, geom: SlabGeometry):
    """Checks the slab's planes; returns their (cap, R, C)."""
    shape = slab_shape(geom, state.xl)
    _check_planes(state[:4], shape)
    _check_planes(state[4:], shape, dtype=torch.int32)
    if geom.capacity > MAX_CAP:
        raise ValueError(f"capacity {geom.capacity} > {MAX_CAP}, the kernel's largest")
    return shape


def _ghost_ptrs(field_ghosts, shape, bot_rows, device):
    """Checked device pointers of ``field_ghosts`` (top planes, then bottom
    planes; zeros without ghosts). ``bot_rows[k]`` rows below for field k."""
    if field_ghosts is None:
        return (0,) * 10
    cap, _, C = shape
    tops, bots = zip(*field_ghosts)
    check_ghosts(tops, [(cap, 1, C)] * 5, device, _FIELD_DTYPES)
    check_ghosts(bots, [(cap, n, C) for n in bot_rows], device, _FIELD_DTYPES)
    return _ptrs(tops, 5) + _ptrs(bots, 5)


def _below_zero(t, rows: int):
    """``t`` with a zero row appended below where it has ``rows`` rows: the
    ghost row R+1 of the planes that carry only rows up to R."""
    return torch.cat([t, torch.zeros_like(t[:, :1])], 1) if t.shape[1] == rows else t


def rebin_axes_call_plain(state: SlabState, geom: SlabGeometry, evac_cap: int,
                          row0=0, field_ghosts=None, col0=0, col_ghosts=None):
    """Plain twin of K2: ``grid_ops.rebin_axes_planes``; with
    ``field_ghosts``, on the planes extended by the ghost rows (1 row above;
    2 below, where row R+1 carries xl and pid only: the x pass reads no
    other field there, so they are zero), and with ``col_ghosts`` also by
    the ghost columns (1 west, 2 east), keeping the interior."""
    if field_ghosts is None:
        if col_ghosts is not None:
            raise ValueError("K2's ghost columns need its ghost rows")
        return rebin_axes_planes(state, geom, evac_cap, row0, col0)
    R, C = state.xl.shape[1:]
    ext = []
    for k, (f, (top, bot)) in enumerate(zip(state, field_ghosts)):
        e = torch.cat([top, f, _below_zero(bot, 1)], 1)
        if col_ghosts is not None:
            west, east = col_ghosts[k]
            e = torch.cat([_below_zero(west, R + 2), e, _below_zero(east, R + 2)], 2)
        ext.append(e)
    c0 = col0 if col_ghosts is None else col0 - 1
    st = _axis_pass2(SlabState(*ext), geom, evac_cap, 0, row0 - 1, c0)
    st = _axis_pass2(st, geom, evac_cap, 1, row0 - 1, c0)
    cols = slice(None) if col_ghosts is None else slice(1, C + 1)
    new = SlabState(*(f[:, 1:R + 1, cols].contiguous() for f in st))
    return new, monitor_planes(state, new, geom, row0, col0)


def _col_ghost_ptrs(col_ghosts, shape, device):
    """Checked device pointers of K2's ``col_ghosts`` (west planes, then
    east planes; zeros without them)."""
    if col_ghosts is None:
        return (0,) * 10
    cap, R, _ = shape
    wests, easts = zip(*col_ghosts)
    rows = [R + 3 if k in (0, 4) else R + 2 for k in range(5)]
    check_ghosts(wests, [(cap, n, 1) for n in rows], device, _FIELD_DTYPES)
    check_ghosts(easts, [(cap, n, 2) for n in rows], device, _FIELD_DTYPES)
    return _ptrs(wests, 5) + _ptrs(easts, 5)


def rebin_axes_call_cuda(state: SlabState, geom: SlabGeometry, evac_cap: int,
                         row0=0, field_ghosts=None, col0=0, col_ghosts=None):
    """K2 on CUDA tensors (``rebin_axes_call_cuda.launches`` counts the
    launches, one a call); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_axes_call_plain(state, geom, evac_cap, row0, field_ghosts,
                                     col0, col_ghosts)
    shape = _check_slab(state, geom)
    cap, R, C = shape
    if col_ghosts is not None and field_ghosts is None:
        raise ValueError("K2's ghost columns need its ghost rows")
    ghosts = _ghost_ptrs(field_ghosts, shape, (2, 1, 1, 1, 2), state.xl.device)
    cghosts = _col_ghost_ptrs(col_ghosts, shape, state.xl.device)
    plan = rebin_plan(shape)
    # The output slab and the count planes are fresh buffers; the input slab
    # is left untouched.
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    lib = _build.kernels()
    err = lib.ppsim_rebin_axes(
        *(t.data_ptr() for t in state), *ghosts, *cghosts,
        *(t.data_ptr() for t in (*out, cnt)),
        state.xl.device.index, cap, R, C, int(row0), int(col0), geom.rows, geom.cols,
        evac_cap, *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem,
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


def rebin_counts_plain(state: SlabState, geom: SlabGeometry, row0=0):
    """Plain twin of K7: the int32 (9, R, C) dirs9 count stack."""
    return rebin_counts(state, geom, row0)[0]


def rebin_shuffle_plain(state: SlabState, counts, geom: SlabGeometry, evac_cap: int,
                        row0=0, field_ghosts=None, count_ghosts=None):
    """Plain twin of K8: ``(SlabState, cnt)``, the shuffled slab and its
    monitor planes. With ghosts (both kinds or neither), the shuffle runs on
    the planes extended by two rows each side, the JAX engine's
    ``_local_rebin_xla`` form: the ghost field row and beyond it an empty
    row, the two ghost count rows; the interior is kept. The empty rows are
    read only by the ghost rows' own decisions, which the interior never
    reads."""
    if (field_ghosts is None) != (count_ghosts is None):
        raise ValueError("K8's shard form takes field and count ghosts together")
    if field_ghosts is None:
        new, _ = rebin_shuffle(state, counts, geom, evac_cap, row0)
        return new, monitor_planes(state, new, geom, row0)
    R = state.xl.shape[1]
    ext = SlabState(*(
        torch.cat([torch.full_like(top, fill), top, f, bot, torch.full_like(bot, fill)], 1)
        for f, (top, bot), fill in zip(state, field_ghosts, SLAB_FILLS)))
    ct, cb = count_ghosts
    new, _ = rebin_shuffle(ext, torch.cat([ct, counts, cb], 1), geom, evac_cap, row0 - 2)
    new = SlabState(*(f[:, 2:R + 2].contiguous() for f in new))
    return new, monitor_planes(state, new, geom, row0)


def rebin_counts_cuda(state: SlabState, geom: SlabGeometry, row0=0):
    """K7 on CUDA tensors (``rebin_counts_cuda.launches`` counts the
    launches); the plain twin on CPU tensors."""
    if state.xl.device.type == "cpu":
        return rebin_counts_plain(state, geom, row0)
    cap, R, C = _check_slab(state, geom)
    counts = torch.empty((9, R, C), dtype=torch.int32, device=state.xl.device)
    err = _build.kernels().ppsim_rebin_counts(
        state.xl.data_ptr(), state.yl.data_ptr(), state.pid.data_ptr(),
        counts.data_ptr(), state.xl.device.index, cap, R, C, int(row0), geom.rows,
        geom.cols, f32(1.0 / geom.bin_size),
        torch.cuda.current_stream(state.xl.device).cuda_stream)
    _build.check_launch(err, "rebin_counts kernel")
    rebin_counts_cuda.launches += 1
    return counts


rebin_counts_cuda.launches = 0


def rebin_shuffle_cuda(state: SlabState, counts, geom: SlabGeometry, evac_cap: int,
                       row0=0, field_ghosts=None, count_ghosts=None):
    """K8 on CUDA tensors (``rebin_shuffle_cuda.launches`` counts the
    launches); the plain twin on CPU tensors. The output slab and the monitor
    planes are fresh buffers; the input slab is left untouched."""
    if state.xl.device.type == "cpu":
        return rebin_shuffle_plain(state, counts, geom, evac_cap, row0,
                                   field_ghosts, count_ghosts)
    if (field_ghosts is None) != (count_ghosts is None):
        raise ValueError("K8's shard form takes field and count ghosts together")
    shape = _check_slab(state, geom)
    cap, R, C = shape
    _check_planes((counts,), (9, R, C), dtype=torch.int32)
    fghosts = _ghost_ptrs(field_ghosts, shape, (1,) * 5, state.xl.device)
    if count_ghosts is None:
        cghosts = (0, 0)
    else:
        check_ghosts(count_ghosts, [(9, 2, C)] * 2, state.xl.device, (torch.int32,) * 2)
        cghosts = _ptrs(count_ghosts, 2)
    plan = shuffle_plan(shape)
    out = SlabState(*(torch.empty_like(t) for t in state))
    cnt = torch.empty((4, R, C), dtype=torch.int32, device=state.xl.device)
    err = _build.kernels().ppsim_rebin_shuffle(
        *(t.data_ptr() for t in (*state, counts)), *fghosts, *cghosts,
        *(t.data_ptr() for t in (*out, cnt)),
        state.xl.device.index, cap, R, C, int(row0), geom.rows, geom.cols, evac_cap,
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
