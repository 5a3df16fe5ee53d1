"""Test inputs shared by the CPU tests and ``chip_smoke.py`` (numpy, from a
seed, so that every device and both packages see identical data)."""

from __future__ import annotations

import math

import numpy as np

from ppsim_tpu_torch.convert import slab3_state_from_numpy, slab_state_from_numpy
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid3d_ops import Geometry3S, Slab3State
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry, SlabState

__all__ = ["STRESS_GEOMETRY", "stress_slab", "STRESS_GEOMETRY3", "stress_slab3",
           "STEP_SLAB_KINDS", "step_slab", "REBIN_EDGE_GEOMETRY",
           "REBIN_EDGE_GEOMETRY3", "rebin_edge_slab", "SHARD_EDGE_GEOMETRY",
           "shard_edge_slab"]

# 13 x 100 physical bins padded to 16 x 128, capacity 4: the JAX package's
# contention geometry (tests/test_grid_ops.py).
STRESS_GEOMETRY = SlabGeometry(rows=13, cols=100, rows_pad=16, cols_pad=128,
                               capacity=4, bin_size=0.05)


def stress_slab(geom: SlabGeometry, seed: int = 0, far_movers: int = 0,
                device="cpu") -> SlabState:
    """Near-capacity random slab whose live particles sit up to one bin
    outside their own (directions in {-1, 0, 1}), plus ``far_movers``
    particles 2.2 bins out (stale-slack violations): heavy acceptance
    contention for the rebin. Same draws as the JAX package's
    ``tests/test_grid_ops._stress_slab``."""
    rng = np.random.default_rng(seed)
    cap, R, C = geom.shape
    occ = rng.integers(0, cap + 1, size=(R, C))
    occ[geom.rows:, :] = 0
    occ[:, geom.cols:] = 0
    xl = np.full((cap, R, C), BIG, np.float32)
    yl = np.full((cap, R, C), BIG, np.float32)
    vx = np.zeros((cap, R, C), np.float32)
    vy = np.zeros((cap, R, C), np.float32)
    pid = np.full((cap, R, C), -1, np.int32)
    k = 0
    bs = geom.bin_size
    for r in range(geom.rows):
        for c in range(geom.cols):
            for s in range(occ[r, c]):
                xl[s, r, c] = rng.uniform(-bs, 2 * bs)
                yl[s, r, c] = rng.uniform(-bs, 2 * bs)
                vx[s, r, c] = rng.normal()
                vy[s, r, c] = rng.normal()
                pid[s, r, c] = k
                k += 1
    for i in range(far_movers):
        r, c = 2 + i, 2
        if pid[0, r, c] < 0:
            pid[0, r, c] = k
            k += 1
        xl[0, r, c] = 2.2 * bs  # raw row direction 2
        yl[0, r, c] = 0.5 * bs
    return slab_state_from_numpy(xl, yl, vx, vy, pid, device=device)


# 6 x 7 x 100 physical bins padded to 6 x 8 x 128, capacity 4, anisotropic
# bin sides: the 3D contention geometry (padding on two axes).
STRESS_GEOMETRY3 = Geometry3S(ys=6, xs=7, zs=100, xs_pad=8, zs_pad=128,
                              ys_pad=6, capacity=4, bsy=0.05, bsx=0.04,
                              bsz=0.03)


def stress_slab3(geom: Geometry3S, seed: int = 0, far_movers: int = 0,
                 device="cpu") -> Slab3State:
    """3D counterpart of :func:`stress_slab`: every physical bin holds 0 to
    ``capacity`` live particles in its lowest slots, each up to one bin
    outside its own on every axis, plus ``far_movers`` particles 2.2 bins out
    along x (stale-slack violations)."""
    rng = np.random.default_rng(seed)
    cap, Y, X, Z = geom.shape
    occ = rng.integers(0, cap + 1, size=(Y, X, Z))
    occ[geom.ys:] = 0
    occ[:, geom.xs:] = 0
    occ[:, :, geom.zs:] = 0
    live = np.arange(cap)[:, None, None, None] < occ[None]
    n = int(live.sum())
    fields = []
    for bs in (geom.bsx, geom.bsy, geom.bsz):
        f = np.full(geom.shape, BIG, np.float32)
        f[live] = rng.uniform(-bs, 2 * bs, n)
        fields.append(f)
    for _ in range(3):
        v = np.zeros(geom.shape, np.float32)
        v[live] = rng.normal(size=n)
        fields.append(v)
    pid = np.full(geom.shape, -1, np.int32)
    pid[live] = np.arange(n, dtype=np.int32)
    for i in range(far_movers):
        y, x, z = 1 + i, 2, 3
        if pid[0, y, x, z] < 0:
            pid[0, y, x, z] = n
            n += 1
            fields[1][0, y, x, z] = 0.5 * geom.bsy
            fields[2][0, y, x, z] = 0.5 * geom.bsz
        fields[0][0, y, x, z] = 2.2 * geom.bsx  # raw x direction 2
    return slab3_state_from_numpy(*fields, pid, device=device)


# The slabs the tiled step kernels (K1, K3, K6) are sensitive to.
STEP_SLAB_KINDS = ("holey", "full", "edge")


def step_slab(cfg, kind: str, device="cpu"):
    """``(geom, slab)`` at the geometry of ``cfg`` (2D or 3D by
    ``cfg.ndim``), made on the CPU from seed 42 and moved to ``device``:

    - ``"holey"``: the plain engine's slab after four rebin periods from the
      init, drifted by up to 0.3 bins (2D) or 0.2 bins (3D) so that pairs
      meet inside the cutoff, then rebinned once more: rebins leave live
      slots scattered among dead ones;
    - ``"full"``: the packed init slab with one interior bin filled to
      capacity on a lattice 0.8 cutoffs apart (its neighbour bins emptied
      first, so that no pair comes closer);
    - ``"edge"``: the packed init slab drifted as ``"holey"``, which keeps
      the particles of the last physical bins beside the padding.
    """
    import torch

    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.initlib import init_particles

    three = cfg.ndim == 3
    eng = get_engine("grid3d" if three else "grid", cfg, device="cpu")
    state = init_particles(cfg, seed=42, method="fast" if three else "reference")
    carry = eng.init_carry(state)
    if kind == "holey":
        for i in range(1, 4 * eng.rebin_every + 1):
            carry = eng.step(carry, i)
    arrays = [t.numpy().copy() for t in carry.slab]
    geom, pid = eng.geom, arrays[-1]
    ndim = 3 if three else 2
    sides = (geom.bsx, geom.bsy, geom.bsz) if three else (geom.bin_size,) * 2
    make = slab3_state_from_numpy if three else slab_state_from_numpy
    rng = np.random.default_rng(7)
    if kind in ("holey", "edge"):
        # the drift of the other step tests: pairs meet inside the cutoff,
        # the closest near half of it
        frac = 0.2 if three else 0.3
        live = pid >= 0
        for k, bs in enumerate(sides):
            arrays[k][live] += rng.uniform(-frac * bs, frac * bs,
                                           live.sum()).astype(np.float32)
        if kind == "holey":  # one more rebin: the drift's leavers move out
            slab, _ = eng.rebin_of(make(*arrays))
            arrays = [t.numpy() for t in slab]
    elif kind == "full":
        cap = geom.capacity
        phys = (geom.ys, geom.xs, geom.zs) if three else (geom.rows, geom.cols)
        centre = tuple(n // 2 for n in phys)
        near = (slice(None),) + tuple(slice(c - 1, c + 2) for c in centre)
        for k in range(ndim):
            arrays[k][near] = BIG
            arrays[ndim + k][near] = 0.0
        pid[near] = -1
        # a lattice 0.8 cutoffs apart about the bin's centre
        side = math.ceil(cap ** (1.0 / ndim) - 1e-9)
        for s in range(cap):
            idx = (s,) + centre
            for k, bs in enumerate(sides):
                step = s // side ** k % side - (side - 1) / 2
                arrays[k][idx] = 0.5 * bs + step * 0.8 * cfg.cutoff
                arrays[ndim + k][idx] = rng.normal()
            pid[idx] = int(pid.max()) + 1
    else:
        raise ValueError(f"unknown step slab kind {kind!r}")
    return geom, make(*arrays, device=torch.device(device))


# Geometries whose fused-rebin plans (K2 and K4: strips of 32 bins) cut the
# array into several strips and segments, padding included:
# 20 x 150 bins in 24 x 160 (2D) and 3 x 18 x 70 in 3 x 20 x 72 (3D),
# capacity 6.
REBIN_EDGE_GEOMETRY = SlabGeometry(rows=20, cols=150, rows_pad=24, cols_pad=160,
                                   capacity=6, bin_size=0.05)
REBIN_EDGE_GEOMETRY3 = Geometry3S(ys=3, xs=18, zs=70, ys_pad=3, xs_pad=20, zs_pad=72,
                                  capacity=6, bsy=0.05, bsx=0.04, bsz=0.03)


def rebin_edge_slab(geom, plan, seed: int = 0, device="cpu"):
    """A slab whose rebin contention sits where the strip-walking rebin
    kernels' blocks meet (K2 and K4, ``csrc/rebin_tile.cuh``; K8,
    ``csrc/rebin_dirs9.cu``): every physical bin holds 0 to
    ``capacity`` live particles in random slots, each up to one bin outside
    its own on every axis; along the strip axis, around every multiple of the
    plan's tile and the last physical bin, and along the walked axis around
    every multiple of its segment, the bins hold ``capacity - 1``,
    ``capacity``, ``capacity``, ``capacity - 1``, ``capacity`` particles
    (offsets -2..2): full bins (no free slot) and one-slot bins on the
    strips' halo bins, with movers both ways. ``geom`` is a 2D
    :class:`SlabGeometry` with a ``cuda_rebin.rebin_plan`` or
    ``cuda_rebin.shuffle_plan``, or a :class:`Geometry3S` with a
    ``cuda_rebin3.rebin3_plan``."""
    rng = np.random.default_rng(seed)
    three = isinstance(geom, Geometry3S)
    cap = geom.capacity
    if three:
        phys = (geom.ys, geom.xs, geom.zs)
        sides = (geom.bsx, geom.bsy, geom.bsz)  # fields xl, yl, zl
        walked, strip = 1, 2  # array axes of the bins (y, x, z)
        make = slab3_state_from_numpy
    else:
        phys = (geom.rows, geom.cols)
        sides = (geom.bin_size,) * 2
        walked, strip = 0, 1
        make = slab_state_from_numpy
    occ = rng.integers(0, cap + 1, size=phys)
    pattern = (cap - 1, cap, cap, cap - 1, cap)
    for axis, step in ((strip, plan.tile[0]), (walked, plan.seg)):
        n = phys[axis]
        for edge in sorted({*range(0, n, step), n - 1}):
            for k, count in zip(range(edge - 2, edge + 3), pattern):
                if 0 <= k < n:
                    occ[(slice(None),) * axis + (k,)] = count
    # occ live slots per bin, at random slot positions
    rank = np.argsort(np.argsort(rng.random((cap, *phys)), axis=0), axis=0)
    live = np.zeros(geom.shape, bool)
    live[(slice(None),) + tuple(slice(0, n) for n in phys)] = rank < occ[None]
    n_live = int(live.sum())
    fields = []
    for bs in sides:
        f = np.full(geom.shape, BIG, np.float32)
        f[live] = rng.uniform(-bs, 2 * bs, n_live)
        fields.append(f)
    for _ in sides:
        v = np.zeros(geom.shape, np.float32)
        v[live] = rng.normal(size=n_live)
        fields.append(v)
    pid = np.full(geom.shape, -1, np.int32)
    pid[live] = rng.permutation(n_live).astype(np.int32)
    return make(*fields, pid, device=device)


# 29 x 70 physical bins in 32 x 128, capacity 4: shards of 16 rows (P = 2)
# or 8 (P = 4), the last one ragged (rows 29-31 are padding), as the
# sharded engine pads rows to P strips of a multiple of 8.
SHARD_EDGE_GEOMETRY = SlabGeometry(rows=29, cols=70, rows_pad=32, cols_pad=128,
                                   capacity=4, bin_size=0.05)


def shard_edge_slab(geom: SlabGeometry, shards: int, seed: int = 0,
                    contention: bool = False, device="cpu") -> SlabState:
    """A slab whose rebin traffic crosses the boundaries of ``shards`` row
    strips of ``geom.rows_pad // shards`` rows: every physical bin holds 0 to
    ``capacity`` live particles in random slots, the first and last rows of
    each strip (and the rows beside them) at least ``capacity - 2``, and
    every particle sits up to one bin outside its own on both axes, so
    movers cross each boundary up, down and diagonally; none is a far mover,
    so nothing is dropped. With ``contention`` those rows hold ``capacity -
    1`` or ``capacity``: the movers across a boundary compete for at most
    one free slot a bin, and the rest are deferred, never dropped."""
    rng = np.random.default_rng(seed)
    cap, R, C = geom.shape
    rl = R // shards
    occ = rng.integers(0, cap + 1, size=(R, C))
    lo = cap - 1 if contention else cap - 2
    for d in range(shards):
        for r in (d * rl - 1, d * rl, d * rl + 1, d * rl + rl - 2, d * rl + rl - 1):
            if 0 <= r < R:
                occ[r] = rng.integers(lo, cap + 1, size=C)
    occ[geom.rows:] = 0
    occ[:, geom.cols:] = 0
    rank = np.argsort(np.argsort(rng.random((cap, R, C)), axis=0), axis=0)
    live = rank < occ[None]
    n = int(live.sum())
    bs = geom.bin_size
    fields = []
    for _ in range(2):
        f = np.full(geom.shape, BIG, np.float32)
        f[live] = rng.uniform(-bs, 2 * bs, n)
        fields.append(f)
    for _ in range(2):
        v = np.zeros(geom.shape, np.float32)
        v[live] = rng.normal(size=n)
        fields.append(v)
    pid = np.full(geom.shape, -1, np.int32)
    pid[live] = rng.permutation(n).astype(np.int32)
    return slab_state_from_numpy(*fields, pid, device=device)
