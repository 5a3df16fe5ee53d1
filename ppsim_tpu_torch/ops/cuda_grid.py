"""Slab-grid force kernels and their plain twins (port of
:mod:`ppsim_tpu.ops.pallas_grid`).

- :func:`grid_step_cuda` launches K1 (``csrc/grid_step.cu``: force, Verlet
  move, wall fold and the per-bin max|v|^2 plane in one pass; it replaces
  ``grid_step_pallas`` with either ``symmetric`` setting, the two-sided form
  being K1's own design); plain twin :func:`grid_step_plain`.
- Both take a shard's inputs (the sharded engine, ``engines/sharded_grid.py``):
  ``row0``, the global row of the planes' first row, and ``ghosts``, the
  neighbouring shards' boundary rows ``(top_xl, top_yl, bot_xl, bot_yl)``,
  each (cap, 1, C) float32, which take the place of the BIG fill above and
  below the planes. K1 is owner-computes, so a ghost row is only read.
- and a tile's (the 2-D tile engine, ``engines/sharded_tile.py``): also
  ``col0``, the global column of the planes' first column, and
  ``col_ghosts``, the boundary columns of the tiles beside
  ``(west_xl, west_yl, east_xl, east_yl)``, each (cap, R + 2, 1) float32:
  rows -1..R of the row-extended neighbour, so the corners come with them.
  They take the place of the fill left and right of the planes and need the
  ghost rows.
- :func:`grid_force_cuda` launches K6 (the same file: the accelerations
  only; it replaces ``grid_force_pallas``); plain twin
  :func:`grid_force_plain`.

On CUDA tensors a wrapper launches its kernel; on CPU tensors it runs the
plain twin; a tensor on any other device raises. There is no fallback from
a kernel to the plain version. All take the force law (``"repulsive"`` or
``"lj"``, the kernels' ``pair_coef.cuh``).

The step kernels (K1, K6 and the 3D K3) are tiled: each block walks a strip
(a tile) of bins along one axis with a ring of row (slab) buffers in shared
memory. :func:`step_plan` (and ``cuda_grid3.step3_plan``) choose the tile,
the segment each block walks, the block size and the shared-memory bytes
from the geometry alone; :func:`tile_smem` repeats the kernels' layout
(``csrc/step_tile.cuh``) and the entry points refuse any other plan, so
the plan can be checked without a card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry, f32, grid_force_xla, move_planes
from ppsim_tpu_torch.physics import lj_coef_from_r2

__all__ = ["grid_step_cuda", "grid_step_plain", "grid_force_cuda", "slab_shape",
           "check_ghosts",
           "grid_force_plain", "MAX_CAP", "LAWS", "pair_args", "kernel_coef_of",
           "TilePlan", "tile_smem", "step_plan", "SMEM_LIMIT", "SMEM_TWO_BLOCKS"]

# Largest slot capacity the kernels take (5 bits of a particle-list entry).
MAX_CAP = 32
# Law ids of csrc/pair_coef.cuh.
LAWS = {"repulsive": 0, "lj": 1}

# The launch plan of the tiled step kernels. Dynamic shared memory a block
# may use on Hopper (227 KB), the block size (the kernels'
# __launch_bounds__, ppsim::kTileThreads), the buffers of the ring (rows or
# slabs y-1, y, y+1 and the one in flight), and the blocks a launch aims
# for: ~24 per SM of an H100's 132, so that the last wave's tail is small.
SMEM_LIMIT = 232_448
# The largest block that leaves room for two on an SM (228 KB less 1 KB per
# block): the tiled kernels' plans narrow their tile until it fits.
SMEM_TWO_BLOCKS = 113 * 1024
TILE_THREADS = 256
_RING = 4
_TARGET_BLOCKS = 24 * 132
# Fewest rows (slabs) a block walks: each block copies two halo rows.
_MIN_SEG = 8
# Strip width of K1/K6 (columns; rows of 66 bins with the halo).
_STRIP_W = 64


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Launch plan of a tiled step kernel: ``tile`` the own bins of a block
    across the walked axis ((w,) columns in 2D, (tx, tz) in 3D), ``seg``
    rows (y-slabs) each block walks, ``threads`` per block, ``blocks`` in
    the launch, ``smem`` bytes of dynamic shared memory."""

    tile: Tuple[int, ...]
    seg: int
    threads: int
    blocks: int
    smem: int


def _align16(b: int) -> int:
    return (b + 15) & ~15


def tile_smem(ncoords: int, cap: int, halo_bins: int, own_bins: int) -> int:
    """Shared-memory bytes of a tiled step kernel's block
    (``csrc/step_tile.cuh`` tile_layout): four buffers of ``ncoords``
    coordinate planes over the halo bins plus their bounds, counts and the
    own slot map, then the particle list, the per-own-bin speed maxima,
    neighbour masks and face bounds, and the scan's warp sums; in 3D also
    the table of the 27 neighbour directions."""
    buf = (_align16(ncoords * cap * halo_bins * 4) + _align16(2 * ncoords * halo_bins * 4)
           + _align16(halo_bins) + _align16(own_bins) + _align16(cap * own_bins))
    dirs = 16 * 27 + _align16(4 * 27) if ncoords == 3 else 0
    return (_RING * buf + _align16(2 * cap * own_bins) + 2 * _align16(4 * own_bins)
            + _align16(2 * ncoords * 4 * own_bins) + 4 * 32 + dirs)


def segment(extent: int, tiles: int) -> int:
    """Rows (slabs) each block walks: enough segments that ``tiles`` x
    segments reaches the target block count, but at least ``_MIN_SEG`` rows
    each (and at most the whole extent)."""
    want = -(-_TARGET_BLOCKS // tiles)
    return min(extent, max(_MIN_SEG, -(-extent // want)))


def step_plan(shape) -> TilePlan:
    """K1/K6 launch plan for slab planes of ``shape`` = (cap, R, C): strips
    of 64 columns, segments of rows. The chooser pads C to a multiple of
    128, so the strips divide it; the kernels also take a ragged strip."""
    cap, R, C = shape
    w = min(_STRIP_W, C)
    strips = -(-C // w)
    seg = segment(R, strips)
    return TilePlan((w,), seg, TILE_THREADS, strips * -(-R // seg),
                    tile_smem(2, cap, w + 2, w))


def _require_law(law: str) -> None:
    if law not in LAWS:
        raise ValueError(f"unknown force_law {law!r}; the kernels have {sorted(LAWS)}")


def pair_args(law: str, cutoff, min_r, mass, law_params=()):
    """The kernels' force-law arguments ``(law_id, c2, cutoff, mr2,
    inv_mass, sig2, lj_k, mass)``, each constant the float32 value its plain
    twin rounds: ``f32(cutoff^2)`` for the repulsive law (grid_ops.pair_coef),
    ``f32(cutoff)^2`` rounded for LJ (physics.lj_coef_from_r2)."""
    _require_law(law)
    if law == "lj":
        eps, sigma = law_params
        c2 = f32(f32(cutoff) * f32(cutoff))
        lj = (f32(sigma * sigma), f32(-24.0 * eps))
    else:
        c2 = f32(cutoff * cutoff)
        lj = (0.0, 0.0)
    return (LAWS[law], c2, f32(cutoff), f32(min_r * min_r), f32(1.0 / mass),
            *lj, f32(mass))


def kernel_coef_of(law: str, cutoff, min_r, mass, law_params=()):
    """``coef(r2)`` with the kernels' pair arithmetic: grid_ops.pair_coef's
    rsqrt form for the repulsive law, physics.lj_coef_from_r2 for LJ."""
    _require_law(law)
    if law == "lj":
        eps, sigma = law_params
        return lambda r2: lj_coef_from_r2(r2, cutoff, min_r, mass, eps, sigma)

    def repulsive(r2):
        rinv = torch.rsqrt(torch.clamp(r2, min=f32(min_r * min_r)))
        inv2 = rinv * rinv
        coef = (inv2 - f32(cutoff) * rinv * inv2) * f32(1.0 / mass)
        return torch.where(r2 <= f32(cutoff * cutoff), coef, 0.0)

    return repulsive


def grid_force_plain(xl, yl, geom: SlabGeometry, cutoff, min_r, mass,
                     law="repulsive", law_params=()):
    """Plain twin of K6: ``grid_force_xla`` with the kernels' pair
    coefficient (:func:`kernel_coef_of`), returning ``(ax, ay)``."""
    coef_of = kernel_coef_of(law, cutoff, min_r, mass, law_params)

    def pair_fn(dx, dy):
        coef = coef_of(dx * dx + dy * dy)
        return coef * dx, coef * dy
    return grid_force_xla(xl, yl, geom, cutoff, min_r, mass, pair_fn=pair_fn)


def grid_step_plain(xl, yl, vx, vy, geom: SlabGeometry, cutoff, min_r, mass,
                    dt, size, law="repulsive", law_params=(), row0=0,
                    ghosts=None, col0=0, col_ghosts=None):
    """Plain twin of K1: :func:`grid_force_plain` + the move, returning
    ``(xl', yl', vx', vy', speed2)`` with ``speed2`` the (R, C) plane of
    per-bin max |v|^2. Like the kernel (and the TPU kernel), slot aliveness
    comes from the position sentinel: dead slots hold exactly BIG. With
    ``ghosts`` the force runs on the planes extended by the ghost rows (and
    with ``col_ghosts`` by the ghost columns: the ring with its corners) and
    the interior is kept (the JAX package's ``_local_plain_xla``); ``row0``
    and ``col0`` enter the move's wall fold."""
    if ghosts is None:
        if col_ghosts is not None:
            raise ValueError("K1's ghost columns need its ghost rows")
        ax, ay = grid_force_plain(xl, yl, geom, cutoff, min_r, mass, law, law_params)
    else:
        tx, ty, bx, by = ghosts
        xe, ye = torch.cat([tx, xl, bx], 1), torch.cat([ty, yl, by], 1)
        cols = slice(None)
        if col_ghosts is not None:
            wx, wy, ex, ey = col_ghosts
            xe, ye = torch.cat([wx, xe, ex], 2), torch.cat([wy, ye, ey], 2)
            cols = slice(1, -1)
        ax, ay = (a[:, 1:-1, cols] for a in grid_force_plain(
            xe, ye, geom, cutoff, min_r, mass, law, law_params))
    xl, yl, vx, vy, speed2 = move_planes(xl, yl, vx, vy, ax, ay,
                                         xl < 0.5 * BIG, geom, dt, size, row0, col0)
    return xl, yl, vx, vy, speed2.amax(dim=0)


def _check_planes(planes, shape, dtype=torch.float32) -> None:
    for t in planes:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous slab planes")
        if t.device != planes[0].device:
            raise ValueError("slab planes on different devices")


def slab_shape(geom: SlabGeometry, planes) -> Tuple[int, int, int]:
    """(cap, R, C) of slab planes: the rows and columns are the planes' own
    (a shard's or a tile's, or the geometry's padded extents), the slots the
    geometry's."""
    return geom.capacity, planes.shape[1], planes.shape[2]


def _ptrs(ghosts, n: int):
    """Device pointers of optional ghost planes (0 when there are none)."""
    return (0,) * n if ghosts is None else tuple(t.data_ptr() for t in ghosts)


def check_ghosts(ghosts, shapes, device, dtypes=None) -> None:
    """Ghost planes: CUDA, contiguous, on ``device``, of ``shapes`` (float32
    unless ``dtypes`` says otherwise)."""
    if len(ghosts) != len(shapes):
        raise ValueError(f"expected {len(shapes)} ghost planes, got {len(ghosts)}")
    for i, (t, shape) in enumerate(zip(ghosts, shapes)):
        _check_planes((t,), shape, torch.float32 if dtypes is None else dtypes[i])
        if t.device != device:
            raise ValueError("ghost planes on another device than the slab")


def grid_step_cuda(xl, yl, vx, vy, geom: SlabGeometry, cutoff, min_r, mass,
                   dt, size, law="repulsive", law_params=(), row0=0,
                   ghosts=None, col0=0, col_ghosts=None):
    """Fused step, same contract as :func:`grid_step_plain`. CUDA tensors
    launch K1 (``grid_step_cuda.launches`` counts the launches); CPU tensors
    run the plain twin."""
    if xl.device.type == "cpu":
        return grid_step_plain(xl, yl, vx, vy, geom, cutoff, min_r, mass, dt,
                               size, law, law_params, row0, ghosts, col0, col_ghosts)
    shape = slab_shape(geom, xl)
    _check_planes((xl, yl, vx, vy), shape)
    cap, R, C = shape
    if ghosts is not None:
        check_ghosts(ghosts, [(cap, 1, C)] * 4, xl.device)
    if col_ghosts is not None:
        if ghosts is None:
            raise ValueError("K1's ghost columns need its ghost rows")
        check_ghosts(col_ghosts, [(cap, R + 2, 1)] * 4, xl.device)
    if cap > MAX_CAP:
        raise ValueError(f"capacity {cap} > {MAX_CAP}, the kernel's largest")
    law_id, *consts = pair_args(law, cutoff, min_r, mass, law_params)
    plan = step_plan(shape)
    outs = [torch.empty_like(xl) for _ in range(4)]
    speed2 = torch.empty((R, C), dtype=torch.float32, device=xl.device)
    lib = _build.kernels()
    err = lib.ppsim_grid_step(
        *(t.data_ptr() for t in (xl, yl, vx, vy)), *_ptrs(ghosts, 4),
        *_ptrs(col_ghosts, 4), *(t.data_ptr() for t in (*outs, speed2)),
        xl.device.index, cap, R, C, int(row0), int(col0), law_id, *plan.tile, plan.seg,
        plan.threads, plan.blocks, plan.smem, f32(geom.bin_size), *consts,
        f32(dt), f32(size), torch.cuda.current_stream(xl.device).cuda_stream)
    _build.check_launch(err, "grid_step kernel")
    grid_step_cuda.launches += 1
    return (*outs, speed2)


grid_step_cuda.launches = 0


def grid_force_cuda(xl, yl, geom: SlabGeometry, cutoff, min_r, mass,
                    law="repulsive", law_params=()):
    """Accelerations ``(ax, ay)``, same contract as :func:`grid_force_plain`.
    CUDA tensors launch K6 (``grid_force_cuda.launches`` counts the
    launches); CPU tensors run the plain twin."""
    if xl.device.type == "cpu":
        return grid_force_plain(xl, yl, geom, cutoff, min_r, mass, law,
                                law_params)
    _check_planes((xl, yl), geom.shape)
    cap, R, C = geom.shape
    if cap > MAX_CAP:
        raise ValueError(f"capacity {cap} > {MAX_CAP}, the kernel's largest")
    law_id, *consts = pair_args(law, cutoff, min_r, mass, law_params)
    plan = step_plan(geom.shape)
    ax, ay = torch.empty_like(xl), torch.empty_like(yl)
    err = _build.kernels().ppsim_grid_force(
        xl.data_ptr(), yl.data_ptr(), ax.data_ptr(), ay.data_ptr(),
        xl.device.index, cap, R, C, law_id, *plan.tile, plan.seg,
        plan.threads, plan.blocks, plan.smem, f32(geom.bin_size), *consts,
        torch.cuda.current_stream(xl.device).cuda_stream)
    _build.check_launch(err, "grid_force kernel")
    grid_force_cuda.launches += 1
    return ax, ay


grid_force_cuda.launches = 0
