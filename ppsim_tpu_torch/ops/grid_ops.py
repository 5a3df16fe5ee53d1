"""Dense slab-grid representation, plain PyTorch (port of
:mod:`ppsim_tpu.ops.grid_ops`).

State lives on the bin grid: fields ``xl, yl, vx, vy`` and ``pid`` have
shape ``(capacity, R, C)`` (slot-slab ``j`` is a dense (R, C) plane),
positions are bin-local, and ``pid < 0`` marks an empty slot, whose position
parks at the ``BIG`` sentinel with zero velocity. Forces are the 3x3 stencil
as shifted planes; rebinning is lazy (every ``rebin_every`` steps) and
loss-free (the axis-factorized shuffle below, or the 9-direction one).

These are the plain twins of the Hopper kernels (``ops/cuda_grid.py``,
``ops/cuda_rebin.py``) and run on any device. Every float32 constant is the
one the JAX package rounds (``float32(1.0 / bin_size)``, not
``1.0f / float32(bin_size)``), so that bin directions and pid placement match
it exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ppsim_tpu_torch.ops.binning import BIG, sort_by_bin

__all__ = [
    "SlabGeometry",
    "SlabState",
    "SLAB_FILLS",
    "RebinMonitors",
    "slab_from_particles",
    "slab_to_particles",
    "slab_positions",
    "id_rows",
    "global_positions",
    "grid_force_xla",
    "grid_move",
    "slab_dirs",
    "rebin_counts",
    "rebin_shuffle",
    "grid_rebin",
    "rebin_axes_planes",
    "monitor_planes",
    "monitors_of_counts",
    "grid_rebin_axes",
]

# The empty-slot value of each slab field (xl, yl, vx, vy, pid): what the
# rows beyond a slab's edges hold.
SLAB_FILLS = (BIG, BIG, 0.0, 0.0, -1)

# Direction codes: d = (dr+1)*3 + (dc+1); 4 = stay.
DIRS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]

# Geometry chooser constants, copied verbatim from the JAX package so that
# both packages choose the identical grid (the cost model was fitted to TPU
# A/B rows; refitting it for the H100 is later work).
_GEOM_COST_A = 0.005479  # VPU pair-plane lane work
_GEOM_COST_B = 0.173282  # plane HBM traffic + capacity-proportional overheads
_GEOM_VMAX = 4.0
_GEOM_OCC_RANGE = (3.0, 13.0)
_GEOM_FREE_MARGIN = 0.4
_GEOM_TIE_EPS = 0.01
GRID_CAPACITY_DEFAULT = 11


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in a float32
    tensor op, like JAX's ``jnp.float32(x)``)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SlabGeometry:
    rows: int  # physical bin rows (row indexes x, the strip axis)
    cols: int
    rows_pad: int  # padded for row-blocking
    cols_pad: int  # padded for lane alignment
    capacity: int
    bin_size: float

    @classmethod
    def for_config(cls, config, row_block: int = 8, lane: int = 128) -> "SlabGeometry":
        """Choose the slab geometry for ``config`` (verbatim copy of the JAX
        package's chooser: the default ``ceil(size / grid_bin_size)`` grid,
        plus, under ``grid_snap_lanes``, lane-exact candidates scored by the
        fitted cost model; ties break toward the lowest capacity)."""
        bins0 = config.grid_bins_per_side
        bs0 = config.grid_bin_size
        cap0 = (GRID_CAPACITY_DEFAULT if config.grid_capacity is None
                else config.grid_capacity)

        def geom(m: int, bs: float, cap: int) -> "SlabGeometry":
            return cls(
                rows=m,
                cols=m,
                rows_pad=-(-m // row_block) * row_block,
                cols_pad=-(-m // lane) * lane,
                capacity=cap,
                bin_size=bs,
            )

        default = geom(bins0, bs0, cap0)
        if not (getattr(config, "grid_snap_lanes", False) and bins0 > lane):
            return default

        n = config.num_parts
        headroom = cap0 - math.ceil(n / (bins0 * bins0))
        # Slack feasibility: (bs - cutoff)/2 >= rebin_every * vmax * dt.
        min_bs = config.cutoff + 2.0 * config.rebin_every * _GEOM_VMAX * config.dt

        def cost(g: "SlabGeometry") -> float:
            occ = n / (g.rows * g.cols)
            pad = (g.rows_pad * g.cols_pad) / (g.rows * g.cols)
            planes = g.capacity * (g.capacity - 1) / 2 + 4 * g.capacity**2
            return (_GEOM_COST_A * planes + _GEOM_COST_B * g.capacity) / occ * pad

        cands = [default]
        for k in range(1, -(-bins0 // lane) + 1):
            m = k * lane
            if m == bins0:
                continue  # identical cover to the default
            bs = config.size / (m - 0.5)  # ceil(size / bs) == m, fp-robust
            occ = n / (m * m)
            cap = math.ceil(occ + _GEOM_FREE_MARGIN) + headroom
            if (bs < min_bs or cap < math.ceil(occ) + 2
                    or not _GEOM_OCC_RANGE[0] <= occ <= _GEOM_OCC_RANGE[1]):
                continue
            cands.append(geom(m, bs, cap))
        best = min(cost(g) for g in cands)
        near = [g for g in cands if cost(g) <= best * (1.0 + _GEOM_TIE_EPS)]
        return min(near, key=lambda g: (g.capacity, cost(g)))

    @property
    def shape(self):
        return (self.capacity, self.rows_pad, self.cols_pad)


class SlabState(NamedTuple):
    xl: torch.Tensor  # (cap, R, C) float32 bin-local x, BIG where empty
    yl: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    pid: torch.Tensor  # int32, -1 where empty


class RebinMonitors(NamedTuple):
    max_occupancy: torch.Tensor  # int32 scalar
    dropped: torch.Tensor  # int32: particles lost (structurally 0; fatal if not)
    deferred: torch.Tensor  # int32: leavers kept in place this rebin (non-fatal)


def _iota(shape, dim: int, device) -> torch.Tensor:
    """int32 index along ``dim`` broadcast to ``shape`` (lax.broadcasted_iota)."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=torch.int32, device=device).view(view)


# ----------------------------------------------------------------- packing
def slab_from_particles(pos, vel, geom: SlabGeometry):
    """Pack a particle list into the slab grid (the init path): stable sort
    by bin, rank within bin, scatter into slot planes. Returns
    (SlabState, overflow), overflow an int32 scalar tensor: particles ranked
    past ``capacity`` in their bin are not packed and counted there."""
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    dev = pos.device
    bs = f32(geom.bin_size)
    inv = f32(1.0 / geom.bin_size)
    r = torch.clamp((pos[:, 0] * inv).to(torch.int32), 0, geom.rows - 1)
    c = torch.clamp((pos[:, 1] * inv).to(torch.int32), 0, geom.cols - 1)
    bin_id = r * geom.cols_pad + c

    plane = geom.rows_pad * geom.cols_pad
    nslots = geom.capacity * plane
    order, sorted_id, rank = sort_by_bin(bin_id)
    keep = rank < geom.capacity
    flat = (rank * plane + sorted_id)[keep]
    max_count = rank.max() + 1

    rr = torch.div(sorted_id, geom.cols_pad, rounding_mode="floor").to(torch.float32)
    cc = (sorted_id % geom.cols_pad).to(torch.float32)
    vals = (
        (pos[order, 0] - rr * bs, BIG),
        (pos[order, 1] - cc * bs, BIG),
        (vel[order, 0], 0.0),
        (vel[order, 1], 0.0),
    )

    def scatter(v, fill, dtype):
        out = torch.full((nslots,), fill, dtype=dtype, device=dev)
        out[flat] = v[keep].to(dtype)
        return out.view(geom.shape)

    state = SlabState(
        *(scatter(v, fill, torch.float32) for v, fill in vals),
        scatter(order.to(torch.int32), -1, torch.int32),
    )
    overflow = torch.clamp(max_count - geom.capacity, min=0).to(torch.int32)
    return state, overflow


def global_positions(state: SlabState, geom: SlabGeometry):
    """(cap, R, C) global coordinates (BIG where empty)."""
    bs = f32(geom.bin_size)
    shape, dev = state.xl.shape, state.xl.device
    row_off = _iota(shape, 1, dev).to(torch.float32) * bs
    col_off = _iota(shape, 2, dev).to(torch.float32) * bs
    alive = state.pid >= 0
    gx = torch.where(alive, state.xl + row_off, BIG)
    gy = torch.where(alive, state.yl + col_off, BIG)
    return gx, gy


def id_rows(columns, pid: torch.Tensor, num_parts: int) -> torch.Tensor:
    """(num_parts, len(columns)) float32 rows in id order from slot planes:
    each slot with ``pid >= 0`` writes its values to row ``pid``; a missing
    id's row stays 0. Empty slots write to one row past the end, cut off:
    nothing waits for the device, as it would for a boolean mask, whose
    length is data (the JAX scatter drops them)."""
    flat = pid.reshape(-1)
    idx = torch.where(flat >= 0, flat, num_parts).long()
    out = torch.zeros((num_parts + 1, len(columns)), dtype=torch.float32,
                      device=pid.device)
    for k, col in enumerate(columns):
        out[idx, k] = col.reshape(-1)
    return out[:num_parts]


def slab_positions(state: SlabState, geom: SlabGeometry, num_parts: int):
    """Id-ordered (N, 2) global positions (a saved frame)."""
    bs = f32(geom.bin_size)
    shape, dev = state.xl.shape, state.xl.device
    row_off = _iota(shape, 1, dev).to(torch.float32) * bs
    col_off = _iota(shape, 2, dev).to(torch.float32) * bs
    return id_rows((state.xl + row_off, state.yl + col_off), state.pid, num_parts)


def slab_to_particles(state: SlabState, geom: SlabGeometry, num_parts: int):
    """Scatter slab state back to id-ordered (N, 2) pos/vel."""
    return (slab_positions(state, geom, num_parts),
            id_rows((state.vx, state.vy), state.pid, num_parts))


# ------------------------------------------------------------------- force
def _shifted(f, dr: int, dc: int, fill=BIG):
    """Plane-shifted view: element (r, c) sees f at (r+dr, c+dc); OOB -> fill."""
    out = torch.roll(f, shifts=(-dr, -dc), dims=(-2, -1))
    if dr:
        out[..., -1 if dr == 1 else 0, :] = fill
    if dc:
        out[..., -1 if dc == 1 else 0] = fill
    return out


def pair_coef(dx, dy, cutoff: float, min_r: float, mass: float):
    """Force coefficient for pair offsets, 0 outside cutoff (the JAX
    package's grid_ops.pair_coef op order: rsqrt, then
    ``(inv2 - cutoff*rinv*inv2) * (1/mass)``)."""
    r2 = dx * dx + dy * dy
    m = r2 <= f32(cutoff * cutoff)
    r2c = torch.clamp(r2, min=f32(min_r * min_r))
    rinv = torch.rsqrt(r2c)
    inv2 = rinv * rinv
    coef = (inv2 - f32(cutoff) * rinv * inv2) * f32(1.0 / mass)
    return torch.where(m, coef, 0.0)


def grid_force_xla(xl, yl, geom: SlabGeometry, cutoff, min_r, mass, pair_fn=None):
    """Plain slab stencil force: for each of the 9 neighbour directions and
    each neighbour slot, one (cap, R, C) pair plane (name kept from the JAX
    package, whose twin is an XLA graph)."""
    if pair_fn is None:
        def pair_fn(dx, dy):
            coef = pair_coef(dx, dy, cutoff, min_r, mass)
            return coef * dx, coef * dy
    bs = geom.bin_size
    ax = torch.zeros_like(xl)
    ay = torch.zeros_like(yl)
    for dr, dc in DIRS:
        xn_all = _shifted(xl, dr, dc)
        yn_all = _shifted(yl, dr, dc)
        offx = f32(dr * bs)
        offy = f32(dc * bs)
        for j in range(geom.capacity):
            dx = (xn_all[j : j + 1] + offx) - xl
            dy = (yn_all[j : j + 1] + offy) - yl
            dax, day = pair_fn(dx, dy)
            ax = ax + dax
            ay = ay + day
    return ax, ay


# -------------------------------------------------------------------- move
def _reflect(local, off, v, L: float):
    """Wall fold of the global coordinate ``local + off`` for out-of-box
    slots only (in-box particles keep exact bin-local positions);
    ``torch.remainder`` is floored like ``jnp.mod``."""
    g = local + off
    out = (g < 0.0) | (g > L)
    m = torch.remainder(g, 2.0 * L)
    folded = L - torch.abs(m - L)
    local = torch.where(out, folded - off, local)
    v = torch.where(out & (m > L), -v, v)
    return local, v


def move_planes(xl, yl, vx, vy, ax, ay, alive, geom: SlabGeometry, dt, size,
                row0=0, col0=0):
    """Verlet + wall reflection on slab planes (reference:
    part1/serial.cpp:44-61); empty slots stay at BIG with zero velocity.
    ``row0`` / ``col0`` are the global row / column of the planes' first row
    / column (a shard's offsets).
    Returns (xl, yl, vx, vy, speed2) with speed2 the (cap, R, C) |v|^2
    planes (0 on empty slots)."""
    bs = f32(geom.bin_size)
    dtf = f32(dt)
    L = f32(size)
    vx = torch.where(alive, vx + ax * dtf, 0.0)
    vy = torch.where(alive, vy + ay * dtf, 0.0)
    xl = xl + vx * dtf
    yl = yl + vy * dtf
    shape, dev = xl.shape, xl.device
    row_off = (row0 + _iota(shape, 1, dev)).to(torch.float32) * bs
    col_off = (col0 + _iota(shape, 2, dev)).to(torch.float32) * bs
    xl, vx = _reflect(xl, row_off, vx, L)
    yl, vy = _reflect(yl, col_off, vy, L)
    xl = torch.where(alive, xl, BIG)
    yl = torch.where(alive, yl, BIG)
    speed2 = torch.where(alive, vx * vx + vy * vy, 0.0)
    return xl, yl, vx, vy, speed2


def grid_move(state: SlabState, accel, geom: SlabGeometry, dt, size, row0=0,
              col0=0):
    """Verlet + wall reflection on the slab grid (``row0`` / ``col0``: the
    global row / column of the state's first row / column); returns
    (new_state, max_speed scalar tensor)."""
    ax, ay = accel
    xl, yl, vx, vy, speed2 = move_planes(
        state.xl, state.yl, state.vx, state.vy, ax, ay, state.pid >= 0,
        geom, dt, size, row0, col0)
    return SlabState(xl, yl, vx, vy, state.pid), torch.sqrt(speed2.max())


# ------------------------------------------------------------------- rebin
def slab_dirs(state: SlabState, geom: SlabGeometry, row0=0, col0=0):
    """Per-slot movement direction (clamped to one hop and to the physical
    grid) plus the far-move flag and aliveness. Empty slots get 0. ``row0``
    / ``col0`` are the global row / column of the state's first row / column
    (a shard's offsets): the clamps at the physical edges ``geom.rows`` and
    ``geom.cols`` take the global indices."""
    inv_bs = f32(1.0 / geom.bin_size)
    alive = state.pid >= 0
    zero = torch.zeros((), dtype=torch.int32, device=state.xl.device)
    # dead slots hold BIG, whose quotient overflows int32: mask before the cast
    dirx_raw = torch.where(alive, torch.floor(state.xl * inv_bs), 0.0).to(torch.int32)
    diry_raw = torch.where(alive, torch.floor(state.yl * inv_bs), 0.0).to(torch.int32)
    far = alive & ((dirx_raw.abs() > 1) | (diry_raw.abs() > 1))
    dirx = torch.clamp(dirx_raw, -1, 1)
    diry = torch.clamp(diry_raw, -1, 1)
    # Never step off the physical grid: clamp at boundary rows/cols.
    shape, dev = dirx.shape, dirx.device
    row = row0 + _iota(shape, 1, dev)
    col = col0 + _iota(shape, 2, dev)
    dirx = torch.minimum(torch.maximum(dirx, -torch.clamp(row, max=1)),
                         torch.clamp(geom.rows - 1 - row, max=1))
    diry = torch.minimum(torch.maximum(diry, -torch.clamp(col, max=1)),
                         torch.clamp(geom.cols - 1 - col, max=1))
    # padded rows/cols see inverted bounds; they hold no particles
    dirx = torch.where(alive, dirx, zero)
    diry = torch.where(alive, diry, zero)
    return dirx, diry, far, alive


def rebin_counts(state: SlabState, geom: SlabGeometry, row0=0, col0=0):
    """The dirs9 count stack and the far-move flags: ``(counts, far)`` with
    ``counts`` the int32 (9, R, C) planes, [d] = live slots moving toward
    ``DIRS[d]`` and [4] (the stay direction) = the live count."""
    dirx, diry, far, alive = slab_dirs(state, geom, row0, col0)
    planes = [(alive if (dr, dc) == (0, 0)
               else alive & (dirx == dr) & (diry == dc)).sum(dim=0, dtype=torch.int32)
              for dr, dc in DIRS]
    return torch.stack(planes), far


def rebin_shuffle(state: SlabState, counts, geom: SlabGeometry, evac_cap: int,
                  row0=0, col0=0):
    """The loss-free 9-direction dense shuffle, given the state's
    :func:`rebin_counts`. Returns ``(SlabState, rejected)`` with ``rejected``
    the int32 (R, C) plane of leavers kept in place. The plain twin of the
    shuffle kernel K8 (ops/cuda_rebin.py).

    Each (source bin, direction) leaver group is admitted to its destination
    only up to the destination's pre-rebin empty-slot budget, under a
    deterministic priority (DIRS order, then rank within the group): the
    leaver of rank ``k`` toward ``d`` is accepted iff ``k < evac_cap`` and
    ``off[d] + k < F`` at the destination, where ``F`` is its pre-rebin free
    slot count and ``off[d]`` the entrants queued there by the groups before
    ``d``. Source and destination evaluate the same predicate from the shared
    count planes, so nothing is ever dropped and no atomics are needed; a
    rejected leaver stays where it is and retries at the next rebin. The
    e-th accepted entrant lands in the destination's empty slot of pre-rebin
    empty-rank ``off[d] + e``.
    """
    cap = geom.capacity
    bs = f32(geom.bin_size)
    i32 = torch.int32
    dirx, diry, _, alive = slab_dirs(state, geom, row0, col0)
    dcode = (dirx + 1) * 3 + (diry + 1)
    F = cap - counts[4]  # pre-rebin empty slots per bin

    # off[d](b): entrants queued at destination b by the groups before d.
    off = {}
    acc = torch.zeros_like(F)
    for d, (dr, dc) in enumerate(DIRS):
        if (dr, dc) == (0, 0):
            continue
        off[d] = acc
        acc = acc + _shifted(counts[d], -dr, -dc, fill=0)

    fields = (state.xl - dirx.to(torch.float32) * bs,
              state.yl - diry.to(torch.float32) * bs, state.vx, state.vy,
              state.pid)
    FILLS = (BIG, BIG, 0.0, 0.0, -1)
    outs = [[f[s] for s in range(cap)] for f in state]
    is_empty = state.pid < 0  # pre-rebin emptiness: the only slots entrants use
    empty_rank = torch.cumsum(is_empty.to(i32), dim=0, dtype=i32) - is_empty.to(i32)

    rejected = torch.zeros_like(F)
    for d, (dr, dc) in enumerate(DIRS):
        if (dr, dc) == (0, 0):
            continue
        mask = alive & (dcode == d)
        # source side: acceptance against the destination's budget
        off_at_dest = _shifted(off[d], dr, dc, fill=0)
        F_at_dest = _shifted(F, dr, dc, fill=0)
        rank = torch.zeros_like(F)
        accepted = []
        for j in range(cap):
            mj = mask[j]
            acc_j = mj & (rank < evac_cap) & (off_at_dest + rank < F_at_dest)
            accepted.append((acc_j, rank))
            rank = rank + mj.to(i32)
            rejected = rejected + (mj & ~acc_j).to(i32)
            for k in range(5):
                outs[k][j] = torch.where(acc_j, FILLS[k], outs[k][j])
        # destination side: insert group d (sources at -d) at empty-rank off+e
        for e in range(evac_cap):
            cand = [torch.full_like(F, fill, dtype=f.dtype)
                    for f, fill in zip(fields, FILLS)]
            for j in range(cap):
                acc_j, rank_j = accepted[j]
                sel = acc_j & (rank_j == e)
                cand = [torch.where(sel, f[j], c) for f, c in zip(fields, cand)]
            cand = [_shifted(c, -dr, -dc, fill=fill) for c, fill in zip(cand, FILLS)]
            valid = cand[4] >= 0
            idx = off[d] + e
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                for k in range(5):
                    outs[k][s] = torch.where(sel, cand[k], outs[k][s])

    return SlabState(*(torch.stack(o) for o in outs)), rejected


def grid_rebin(state: SlabState, geom: SlabGeometry, evac_cap: int, row0=0,
               col0=0):
    """The 9-direction rebin with the JAX package's monitors
    (``grid_ops.grid_rebin``): ``deferred`` counts the leavers rejected
    before the shuffle, ``dropped`` = particles lost + far movers (flagged on
    the pre-rebin state), ``max_occupancy`` after the rebin. Sums in int64."""
    counts, far = rebin_counts(state, geom, row0, col0)
    new, rejected = rebin_shuffle(state, counts, geom, evac_cap, row0, col0)
    i64 = torch.int64
    occ = (new.pid >= 0).sum(dim=0, dtype=torch.int32)
    dropped = counts[4].sum(dtype=i64) - occ.sum(dtype=i64) + far.sum(dtype=i64)
    return new, RebinMonitors(occ.max(), dropped.to(torch.int32),
                              rejected.sum(dtype=i64).to(torch.int32))


def _axis_pass2(state: SlabState, geom: SlabGeometry, evac_cap: int, axis: int,
                row0=0, col0=0):
    """One 1-D rebin pass along ``axis`` (0 = rows/x, 1 = cols/y): movers
    take one hop under the loss-free acceptance contract, rejected movers
    stay in place. Returns the new state.

    Contract (shared with the Hopper kernel, decision for decision): in each
    source bin, movers toward ``d`` are ranked in slot order; the mover of
    rank ``k`` is accepted iff ``k < evac_cap`` and ``off + k < F`` at the
    destination, where ``F`` is the destination's pre-pass free-slot count
    and ``off`` the entrants queued there before direction ``d`` (direction
    -1 has priority; ``off[+1](b)`` is the count of -1 movers AT bin b+1).
    The e-th accepted entrant lands in the destination's empty slot of
    pre-pass empty-rank ``off + e``. Source and destination evaluate the same
    predicate, so no atomics and no communication are needed.
    """
    cap = geom.capacity
    bs = f32(geom.bin_size)
    dirx, diry, _, alive = slab_dirs(state, geom, row0, col0)
    adir = (dirx, diry)[axis]

    def shift(f, d, fill):
        return _shifted(f, d if axis == 0 else 0, d if axis == 1 else 0,
                        fill=fill)

    i32 = torch.int32
    F = cap - alive.sum(dim=0, dtype=i32)
    FILLS = (BIG, BIG, 0.0, 0.0)
    fields = [state.xl, state.yl, state.vx, state.vy]
    # recenter the moving coordinate into the destination bin's local frame
    fields[axis] = fields[axis] - adir.to(torch.float32) * bs

    outs = [[f[s] for s in range(cap)]
            for f in (state.xl, state.yl, state.vx, state.vy, state.pid)]
    is_empty = state.pid < 0
    empty_rank = torch.cumsum(is_empty.to(i32), dim=0, dtype=i32) - is_empty.to(i32)

    counts_m = (alive & (adir == -1)).sum(dim=0, dtype=i32)
    off_of = {-1: torch.zeros_like(F), 1: shift(counts_m, 1, 0)}
    for d in (-1, 1):
        mask = alive & (adir == d)
        off_at_dest = shift(off_of[d], d, 0)
        F_at_dest = shift(F, d, 0)
        rank = torch.zeros_like(F)
        accepted = []
        for j in range(cap):
            mj = mask[j]
            acc_j = mj & (rank < evac_cap) & (off_at_dest + rank < F_at_dest)
            accepted.append((acc_j, rank))
            rank = rank + mj.to(i32)
        for j in range(cap):
            acc_j, _ = accepted[j]
            for k in range(4):
                outs[k][j] = torch.where(acc_j, FILLS[k], outs[k][j])
            outs[4][j] = torch.where(acc_j, -1, outs[4][j])
        for e in range(evac_cap):
            evac = [torch.full_like(F, FILLS[k], dtype=torch.float32)
                    for k in range(4)]
            epid = torch.full_like(F, -1)
            for j in range(cap):
                acc_j, rank_j = accepted[j]
                sel = acc_j & (rank_j == e)
                for k in range(4):
                    evac[k] = torch.where(sel, fields[k][j], evac[k])
                epid = torch.where(sel, state.pid[j], epid)
            cpid = shift(epid, -d, -1)
            cflds = [shift(evac[k], -d, FILLS[k]) for k in range(4)]
            valid = cpid >= 0
            idx = off_of[d] + e
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                for k in range(4):
                    outs[k][s] = torch.where(sel, cflds[k], outs[k][s])
                outs[4][s] = torch.where(sel, cpid, outs[4][s])

    return SlabState(*(torch.stack(o) for o in outs))


def rebin_axes_planes(state: SlabState, geom: SlabGeometry, evac_cap: int,
                      row0=0, col0=0):
    """Axis-factorized 2D rebin, rows (x) pass then cols (y) pass, returning
    ``(SlabState, cnt)`` with ``cnt`` the int32 (4, R, C) monitor planes
    ``[far_pre, alive_pre, alive_post, resid]`` per bin. The plain twin of
    the rebin kernel K2 (ops/cuda_rebin.py).

    Far movers (a 2-bin drift, a stale-slack violation) are counted on the
    PRE-rebin state: each pass clamps to one hop, so afterwards they would
    look like benign movers. ``resid`` counts movers left after both passes.
    """
    st = _axis_pass2(state, geom, evac_cap, 0, row0, col0)
    st = _axis_pass2(st, geom, evac_cap, 1, row0, col0)
    return st, monitor_planes(state, st, geom, row0, col0)


def monitor_planes(pre: SlabState, post: SlabState, geom: SlabGeometry, row0=0,
                   col0=0):
    """The int32 (4, R, C) monitor planes of a rebin from ``pre`` to
    ``post``: ``[far_pre, alive_pre, alive_post, resid]``, ``resid`` = live
    slots of ``post`` still pointing out of their bin."""
    i32 = torch.int32
    _, _, far0, alive0 = slab_dirs(pre, geom, row0, col0)
    dx2, dy2, _, alive2 = slab_dirs(post, geom, row0, col0)
    return torch.stack([
        far0.sum(dim=0, dtype=i32),
        alive0.sum(dim=0, dtype=i32),
        alive2.sum(dim=0, dtype=i32),
        (alive2 & ((dx2 != 0) | (dy2 != 0))).sum(dim=0, dtype=i32),
    ])


def monitors_of_counts(cnt) -> RebinMonitors:
    """Rebin monitors from the (4, R, C) count planes: ``max_occupancy`` after
    the rebin, ``dropped`` = particles lost plus far movers, ``deferred`` =
    movers left. Summed in int64 and narrowed: a float32 sum loses integer
    exactness past 2^24, below the 20.97M main-path n."""
    far_pre, alive_pre, alive_post, resid = cnt
    lost = alive_pre.sum(dtype=torch.int64) - alive_post.sum(dtype=torch.int64)
    dropped = lost + far_pre.sum(dtype=torch.int64)
    return RebinMonitors(alive_post.max().to(torch.int32), dropped.to(torch.int32),
                         resid.sum(dtype=torch.int64).to(torch.int32))


def grid_rebin_axes(state: SlabState, geom: SlabGeometry, evac_cap: int, row0=0,
                    col0=0):
    """Axis-factorized 2D rebin with its monitors (see :func:`rebin_axes_planes`)."""
    st, cnt = rebin_axes_planes(state, geom, evac_cap, row0, col0)
    return st, monitors_of_counts(cnt)
