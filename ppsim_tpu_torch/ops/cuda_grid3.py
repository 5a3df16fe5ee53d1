"""Fused 3D slab-grid step: the Hopper kernel K3 and its plain twin (port of
:mod:`ppsim_tpu.ops.pallas_grid3d`).

:func:`grid3_step_cuda` launches ``csrc/grid3_step.cu`` (27-bin force,
Verlet move, 3-axis wall fold and the per-bin max|v|^2 plane in one pass) on
CUDA tensors and runs :func:`grid3_step_plain` on CPU tensors; a tensor on
any other device raises. There is no fallback from the kernel to the plain
version. One kernel covers both TPU variants (``_step3_kernel`` and
``_step3_kernel_nospeed``, which exists only because of the TPU's VMEM): the
speed plane is always emitted. The kernel is tiled like K1
(``cuda_grid``): :func:`step3_plan` gives its launch plan.

Both take a shard's inputs (the sharded engine,
``engines/sharded_grid3d.py``): ``y0``, the global index of the planes'
first y slab, and ``ghosts``, the neighbouring shards' boundary slabs
``(top_xl, top_yl, top_zl, bot_xl, bot_yl, bot_zl)``, each (cap, 1, X, Z)
float32 (the JAX package's layout), which take the place of the empty slabs
above and below the planes. K3 is owner-computes, so a ghost slab is only
read.

Both count into ``counts``, when given: an int64 tensor of four on the
planes' device. Its first element gains the step's pairs inside the cutoff
(each live own particle with every live slot within the cutoff in its 27
bins, itself included); the kernel also adds its warp passes of the pair
coefficient, its distance tests and its warp passes of the test (each pass
of its walk runs several test slots a lane, each counted) to the other
three, which the plain twin leaves as they are. K3 tests every pair
it does not cut, and cuts only pairs outside the cutoff, so both count the
same pairs. With ``counts`` K3 launches its counting instance, which is
slower than the one without.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.cuda_grid import (
    MAX_CAP, SMEM_TWO_BLOCKS, TILE_THREADS, TilePlan, _check_planes, _ptrs,
    check_ghosts, kernel_coef_of, pair_args, segment, tile_smem,
)
from ppsim_tpu_torch.ops.grid3d_ops import Geometry3S, grid3_force_xla, move3_planes
from ppsim_tpu_torch.ops.grid_ops import f32

__all__ = ["grid3_step_cuda", "grid3_step_plain", "step3_plan", "slab3_shape",
           "new_counts"]

# (x, z) tiles of K3, widest first; the plan takes the first whose block
# leaves room for two blocks on an SM.
_TILES3 = ((4, 16), (4, 8))


def slab3_shape(geom: Geometry3S, planes):
    """(cap, Y, X, Z) of slab planes: the y slabs are the planes' own (a
    shard's slabs, or the geometry's padded slabs), x and z the geometry's."""
    return geom.capacity, planes.shape[1], geom.xs_pad, geom.zs_pad


def step3_plan(shape) -> TilePlan:
    """K3 launch plan for slab planes of ``shape`` = (cap, Y, X, Z): (x, z)
    tiles of 4 x 16 bins (4 x 8 at capacities whose ring would not leave
    room for two blocks per SM, up to 32), walked in y in segments. The
    choosers pad X to a multiple of 8 and Z to one of 128, so the tiles
    divide them; the kernel also takes ragged edges."""
    cap, Y, X, Z = shape
    for tx, tz in _TILES3:
        smem = tile_smem(3, cap, (tx + 2) * (tz + 2), tx * tz)
        if smem <= SMEM_TWO_BLOCKS:
            break
    tiles = -(-X // tx) * -(-Z // tz)
    seg = segment(Y, tiles)
    return TilePlan((tx, tz), seg, TILE_THREADS, tiles * -(-Y // seg), smem)


def new_counts(device) -> torch.Tensor:
    """Zeroed counters for ``counts``: (pairs inside the cutoff, warp
    passes of the pair coefficient, distance tests, warp passes of the
    test)."""
    return torch.zeros(4, dtype=torch.int64, device=device)


def grid3_step_plain(xl, yl, zl, vx, vy, vz, geom: Geometry3S, cutoff, min_r,
                     mass, dt, size, law="repulsive", law_params=(), y0=0,
                     ghosts=None, counts=None):
    """Plain twin of K3: ``grid3_force_xla`` with the kernels' pair
    arithmetic, then the move, returning ``(xl', yl', zl', vx', vy', vz',
    speed2)`` with ``speed2`` the (Y, X, Z) plane of per-bin max |v|^2. Slot
    aliveness comes from the position sentinel (dead slots hold exactly BIG),
    as in the kernel and the TPU kernel. With ``ghosts`` the force runs on
    the planes extended by the ghost slabs and the interior is kept (the JAX
    package's ``_local_plain_xla``); ``y0`` enters the wall fold.
    ``counts`` gains the step's pairs inside the cutoff (module docstring)."""
    coef_of = kernel_coef_of(law, cutoff, min_r, mass, law_params)
    c2 = None if counts is None else pair_args(law, cutoff, min_r, mass, law_params)[1]
    if ghosts is None:
        force = grid3_force_xla(xl, yl, zl, geom, coef_of, c2)
    else:
        if len(ghosts) != 6:
            raise ValueError(f"expected 6 ghost planes, got {len(ghosts)}")
        ext = [torch.cat([top, f, bot], 1)
               for f, top, bot in zip((xl, yl, zl), ghosts[:3], ghosts[3:])]
        force = [a[:, 1:-1] for a in grid3_force_xla(*ext, geom, coef_of, c2)]
    alive = xl < 0.5 * BIG
    if counts is not None:
        counts[0] += torch.where(alive, force[3], 0).sum()
    *planes, speed2 = move3_planes(xl, yl, zl, vx, vy, vz, *force[:3], alive,
                                   geom, dt, size, y0)
    return (*planes, speed2.amax(dim=0))


def grid3_step_cuda(xl, yl, zl, vx, vy, vz, geom: Geometry3S, cutoff, min_r,
                    mass, dt, size, law="repulsive", law_params=(), y0=0,
                    ghosts=None, counts=None):
    """Fused step, same contract as :func:`grid3_step_plain`. CUDA tensors
    launch K3 (``grid3_step_cuda.launches`` counts the launches; a shard's
    inputs launch its SHARD instance); CPU tensors run the plain twin."""
    if xl.device.type == "cpu":
        return grid3_step_plain(xl, yl, zl, vx, vy, vz, geom, cutoff, min_r,
                                mass, dt, size, law, law_params, y0, ghosts, counts)
    planes = (xl, yl, zl, vx, vy, vz)
    shape = slab3_shape(geom, xl)
    _check_planes(planes, shape)
    cap, Y, X, Z = shape
    if ghosts is not None:
        check_ghosts(ghosts, [(cap, 1, X, Z)] * 6, xl.device)
    if counts is not None and (counts.device != xl.device or counts.dtype != torch.int64
                               or counts.shape != (4,) or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int64 tensor of 4 on the "
                         f"planes' device, got {counts.dtype} {tuple(counts.shape)} "
                         f"on {counts.device}")
    if cap > MAX_CAP:
        raise ValueError(f"capacity {cap} > {MAX_CAP}, the kernel's largest")
    law_id, *consts = pair_args(law, cutoff, min_r, mass, law_params)
    plan = step3_plan(shape)
    outs = [torch.empty_like(xl) for _ in range(6)]
    speed2 = torch.empty((Y, X, Z), dtype=torch.float32, device=xl.device)
    lib = _build.kernels()
    err = lib.ppsim_grid3_step(
        *(t.data_ptr() for t in planes), *_ptrs(ghosts, 6),
        *(t.data_ptr() for t in (*outs, speed2)),
        0 if counts is None else counts.data_ptr(),
        xl.device.index, cap, Y, X, Z, int(y0), geom.xs, geom.zs, law_id, *plan.tile,
        plan.seg, plan.threads, plan.blocks, plan.smem, f32(geom.bsx), f32(geom.bsy), f32(geom.bsz), *consts,
        f32(dt), f32(size), torch.cuda.current_stream(xl.device).cuda_stream)
    _build.check_launch(err, "grid3_step kernel")
    grid3_step_cuda.launches += 1
    return (*outs, speed2)


grid3_step_cuda.launches = 0
