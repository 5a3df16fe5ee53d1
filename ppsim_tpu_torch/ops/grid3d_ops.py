"""Dense 3D slab grid, plain PyTorch (port of :mod:`ppsim_tpu.ops.grid3d_ops`).

The 3D generalization of the 2D slab grid (``ops/grid_ops.py``): fields
``xl, yl, zl, vx, vy, vz`` and ``pid`` have shape ``(capacity, Y, X, Z)``
(one (X, Z) plane per slot and y slab), positions are bin-local, and
``pid < 0`` marks an empty slot, whose position parks at ``BIG`` with zero
velocity. The 3x3x3 stencil is 27 shifted planes; the rebin factorizes into
three one-hop axis passes (x, z, then y) under the 2D loss-free acceptance
contract (``grid_ops._axis_pass2``).

These are the plain twins of the 3D Hopper kernels (``ops/cuda_grid3.py``,
``ops/cuda_rebin3.py``) and run on any device. Geometry constants and float32
rounding follow the JAX package exactly, so both packages choose the same
grid and put every particle into the same (bin, slot).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ppsim_tpu_torch.ops.binning import BIG, sort_by_bin
from ppsim_tpu_torch.ops.grid_ops import RebinMonitors, f32, id_rows

__all__ = [
    "DIRS3",
    "STAY3",
    "Geometry3S",
    "Slab3State",
    "slab3_from_particles",
    "slab3_from_particles_spill",
    "slab3_to_particles",
    "slab3_positions",
    "grid3_force_xla",
    "move3_planes",
    "grid3_move",
    "slab3_dirs",
    "grid3_rebin_axes",
    "rebin3_monitors",
]

# Direction codes: d = ((dy+1)*3 + (dx+1))*3 + (dz+1); 13 = stay.
DIRS3 = [
    (dy, dx, dz)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    for dz in (-1, 0, 1)
]
STAY3 = 13

# Geometry chooser constants, copied verbatim from the JAX package so that
# both packages choose the identical grid (they were calibrated on a TPU;
# recalibrating them for the H100 is later work).
# Rebin cost relative to one force step at equal padded volume (ranks
# candidate geometries against their cadence in for_config).
_REBIN_COST_FACTOR = 0.42
# Auto slot capacity (grid3_capacity = None); the LJ law gets a floor once
# the grid reaches _LJ_FLOOR_BINS bins (attractive clustering).
_AUTO3_BASE_CAPACITY = 10
_LJ_FLOOR_BINS = 2 ** 21
_LJ_FLOOR_CAPACITY = 13
# Speed-tail margin of the auto rebin cadence (speeds heat past grid3_vmax).
_VMAX_TAIL = 1.5


@dataclasses.dataclass(frozen=True)
class Geometry3S:
    ys: int  # physical y bins (outer axis)
    xs: int
    zs: int  # z bins (innermost, contiguous axis)
    xs_pad: int
    zs_pad: int
    ys_pad: int  # array y extent (== ys on one device)
    capacity: int
    # Per-axis bin sides; bsx * bsy * bsz == grid3_bin_size^3.
    bsy: float
    bsx: float
    bsz: float

    @classmethod
    def for_config(cls, config, sublane: int = 8, lane: int = 128) -> "Geometry3S":
        """Choose the 3D grid for ``config`` (verbatim copy of the JAX
        package's chooser): the isotropic grid, plus under
        ``grid3_snap_lanes`` a candidate with z snapped to a multiple of 128
        bins and x to a multiple of 8 (y absorbs the occupancy), scored by
        capacity-weighted padded volume times rebin cost."""
        n0 = config.grid3_bins_per_side
        b0 = config.grid3_bin_size
        L = config.size
        cands = [dict(ys=n0, xs=n0, zs=n0, bsy=b0, bsx=b0, bsz=b0)]
        if config.grid3_snap_lanes and n0 > 1:
            min_bs = config.cutoff + 2.0 * config.grid3_vmax * config.dt
            vol = b0 ** 3
            for zs in sorted({lane * (n0 // lane), lane * -(-n0 // lane)}):
                if zs < lane:
                    continue
                bsz = L / zs
                if bsz < min_bs:
                    continue
                bxy = math.sqrt(vol / bsz)
                xs = max(sublane, -(-math.ceil(L / bxy) // sublane) * sublane)
                bsx = L / xs
                if bsx < min_bs:
                    continue
                bsy = vol / (bsx * bsz)
                if bsy < min_bs:
                    continue
                ys = max(1, math.ceil(L / bsy))
                cands.append(dict(ys=ys, xs=xs, zs=zs,
                                  bsy=bsy, bsx=bsx, bsz=bsz))

        base_capacity = config.grid3_capacity
        lj_floor = 0
        if base_capacity is None:
            base_capacity = _AUTO3_BASE_CAPACITY
            if config.force_law == "lj" and n0 ** 3 >= _LJ_FLOOR_BINS:
                lj_floor = _LJ_FLOOR_CAPACITY

        def geom_of(c):
            # Anisotropy headroom: arrival traffic along an axis scales as
            # 1/bs_axis, so a thin snapped axis earns up to 2 extra slots.
            ratio = b0 / min(c["bsx"], c["bsy"], c["bsz"])
            extra = min(2, max(0, math.ceil(2.0 * (ratio - 1.0) - 1e-9)))
            capacity = base_capacity + extra
            if lj_floor:
                capacity = max(capacity, lj_floor)
            return cls(
                ys=c["ys"], xs=c["xs"], zs=c["zs"],
                xs_pad=-(-c["xs"] // sublane) * sublane,
                zs_pad=-(-c["zs"] // lane) * lane,
                ys_pad=c["ys"],
                capacity=capacity,
                bsy=c["bsy"], bsx=c["bsx"], bsz=c["bsz"],
            )

        def cost(g):
            vol_pad = g.capacity * g.ys * g.xs_pad * g.zs_pad
            return vol_pad * (1.0 + _REBIN_COST_FACTOR / g.cadence(config))

        return min((geom_of(c) for c in cands), key=cost)

    def cadence(self, config) -> int:
        """Rebin cadence: ``rebin3_every``, else the largest cadence (at most
        8) whose drift at ``_VMAX_TAIL * grid3_vmax`` stays inside the
        tightest axis's stale-bin slack."""
        if config.rebin3_every is not None:
            return config.rebin3_every
        slack = (min(self.bsx, self.bsy, self.bsz) - config.cutoff) / 2.0
        step_drift = _VMAX_TAIL * config.grid3_vmax * config.dt
        return max(1, min(8, int(slack / step_drift)))

    @property
    def shape(self):
        return (self.capacity, self.ys_pad, self.xs_pad, self.zs_pad)

    @property
    def plane(self) -> int:
        return self.ys_pad * self.xs_pad * self.zs_pad


class Slab3State(NamedTuple):
    xl: torch.Tensor  # (cap, Y, X, Z) float32 bin-local x, BIG where empty
    yl: torch.Tensor
    zl: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    pid: torch.Tensor  # int32, -1 where empty


# Fill value of each Slab3State field for an empty slot.
FILLS3 = (BIG, BIG, BIG, 0.0, 0.0, 0.0, -1)


def _iota(shape, dim: int, device) -> torch.Tensor:
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=torch.int32, device=device).view(view)


# ----------------------------------------------------------------- packing
def _home_bins(pos, geom: Geometry3S):
    """Per-axis home bin indices and the padded-flat bin id of each row."""
    def axis(col, bs, n):
        return torch.clamp((pos[:, col] * f32(1.0 / bs)).to(torch.int32), 0, n - 1)

    bx = axis(0, geom.bsx, geom.xs)
    by = axis(1, geom.bsy, geom.ys)
    bz = axis(2, geom.bsz, geom.zs)
    return bx, by, bz, (by * geom.xs_pad + bx) * geom.zs_pad + bz


def slab3_from_particles(pos, vel, geom: Geometry3S):
    """Pack an (N, 3) particle list into the 3D slab grid (the init path):
    stable sort by bin, rank within bin, scatter into slot planes. Returns
    ``(Slab3State, overflow)``: particles ranked past ``capacity`` in their
    bin are not packed and counted in the int32 scalar ``overflow``."""
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    _, _, _, bin_id = _home_bins(pos, geom)
    return _scatter_pack(pos, vel, bin_id, geom)


def _scatter_pack(pos, vel, bin_id, geom: Geometry3S):
    """Sort+rank+scatter shared by the plain and spill packers. A particle's
    local coordinates are relative to the origin of ``bin_id`` (its
    residence bin), so a spilled particle sits just outside [0, bs)."""
    plane = geom.plane
    nslots = geom.capacity * plane
    order, sorted_id, rank = sort_by_bin(bin_id)
    keep = rank < geom.capacity
    flat = (rank * plane + sorted_id)[keep]
    max_count = rank.max() + 1

    xz = geom.xs_pad * geom.zs_pad
    yy = torch.div(sorted_id, xz, rounding_mode="floor").to(torch.float32)
    xx = torch.div(sorted_id % xz, geom.zs_pad, rounding_mode="floor").to(torch.float32)
    zz = (sorted_id % geom.zs_pad).to(torch.float32)
    p = pos[order]
    v = vel[order]
    vals = (
        p[:, 0] - xx * f32(geom.bsx),
        p[:, 1] - yy * f32(geom.bsy),
        p[:, 2] - zz * f32(geom.bsz),
        v[:, 0], v[:, 1], v[:, 2],
        order.to(torch.int32),
    )

    def scatter(vals, fill):
        dtype = torch.int32 if fill == -1 else torch.float32
        out = torch.full((nslots,), fill, dtype=dtype, device=pos.device)
        out[flat] = vals[keep].to(dtype)
        return out.view(geom.shape)

    state = Slab3State(*(scatter(v, fill) for v, fill in zip(vals, FILLS3)))
    overflow = torch.clamp(max_count - geom.capacity, min=0).to(torch.int32)
    return state, overflow


def slab3_from_particles_spill(pos, vel, geom: Geometry3S, depth: float):
    """Deferral-style init pack: in every bin that the t = 0 lattice packs
    past ``capacity``, move the excess particles that lie within ``depth``
    of a face into the face-adjacent bin (one with a free slot) instead of
    raising the capacity. The result looks like a mid-run rebin deferral,
    which the stencil and the monitors already handle. If several donors
    fill the same receiver the final overflow count says so and the caller
    raises the capacity instead (loss-free either way).

    Returns ``(Slab3State, overflow, spilled)``, int32 scalars."""
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    bx, by, bz, bid = _home_bins(pos, geom)
    cap = geom.capacity
    n = pos.shape[0]
    nbins = geom.plane
    counts = torch.bincount(bid.long(), minlength=nbins).to(torch.int32)
    need = counts[bid.long()] - cap  # > 0 exactly in overfull bins
    depth_f = f32(depth)

    # Nearest eligible face per particle: an in-grid neighbour with a free
    # slot at face distance <= depth (strides of bid = (by*X + bx)*Z + bz).
    best_dist = torch.full((n,), BIG, dtype=torch.float32, device=pos.device)
    best_delta = torch.zeros((n,), dtype=torch.int32, device=pos.device)
    axes = (
        (bx, pos[:, 0], geom.bsx, geom.xs, geom.zs_pad),
        (by, pos[:, 1], geom.bsy, geom.ys, geom.xs_pad * geom.zs_pad),
        (bz, pos[:, 2], geom.bsz, geom.zs, 1),
    )
    for b_ax, p_ax, bs_ax, dim_ax, stride in axes:
        lo = b_ax.to(torch.float32) * f32(bs_ax)
        for sgn, dist in ((-1, p_ax - lo), (1, lo + f32(bs_ax) - p_ax)):
            nb = b_ax + sgn
            ok = (nb >= 0) & (nb < dim_ax)
            nbid = torch.clamp(bid + sgn * stride, 0, nbins - 1)
            ok &= counts[nbid.long()] < cap
            cand = ok & (dist <= depth_f) & (dist < best_dist)
            best_delta = torch.where(cand, sgn * stride, best_delta)
            best_dist = torch.where(cand, dist, best_dist)

    elig = (need > 0) & (best_delta != 0)
    # Spill the first (count - capacity) eligibles of each bin in index
    # order: key parity encodes eligibility, eligibles sort first.
    key = bid * 2 + (1 - elig.to(torch.int32))
    order2, sorted_key, rank2 = sort_by_bin(key)
    sel = (sorted_key % 2 == 0) & (rank2 < need[order2])
    spill = torch.zeros((n,), dtype=torch.bool, device=pos.device)
    spill[order2] = sel
    new_bid = torch.where(spill, bid + best_delta, bid)
    state, overflow = _scatter_pack(pos, vel, new_bid, geom)
    return state, overflow, spill.sum().to(torch.int32)


def _offsets(geom: Geometry3S, shape, device, y0=0):
    """Global (x, y, z) bin-origin offsets broadcast over ``shape``; ``y0``
    is the global index of the first y slab (a shard's offset)."""
    nd = len(shape)
    y = (y0 + _iota(shape, nd - 3, device)).to(torch.float32) * f32(geom.bsy)
    x = _iota(shape, nd - 2, device).to(torch.float32) * f32(geom.bsx)
    z = _iota(shape, nd - 1, device).to(torch.float32) * f32(geom.bsz)
    return x, y, z


def slab3_positions(state: Slab3State, geom: Geometry3S, num_parts: int):
    """Id-ordered (N, 3) global positions (a saved frame)."""
    xo, yo, zo = _offsets(geom, state.xl.shape, state.xl.device)
    return id_rows((state.xl + xo, state.yl + yo, state.zl + zo), state.pid,
                   num_parts)


def slab3_to_particles(state: Slab3State, geom: Geometry3S, num_parts: int):
    """Scatter slab state back to id-ordered (N, 3) pos/vel."""
    return (slab3_positions(state, geom, num_parts),
            id_rows((state.vx, state.vy, state.vz), state.pid, num_parts))


# ------------------------------------------------------------------- shift
def _shifted3(f, dy: int, dx: int, dz: int, geom: Geometry3S, fill=BIG):
    """Element (y, x, z) sees f at bin (y+dy, x+dx, z+dz); off the array in
    y, or past the physical x/z edge, it sees ``fill`` (the JAX package's
    roll-and-mask, wrap-around into padding included)."""
    nd = f.dim()
    out = torch.roll(f, shifts=(-dy, -dx, -dz), dims=(nd - 3, nd - 2, nd - 1))
    if dy:
        out[..., f.shape[nd - 3] - 1 if dy == 1 else 0, :, :] = fill
    if dx:
        out[..., min(geom.xs - 1, f.shape[nd - 2] - 1) if dx == 1 else 0, :] = fill
    if dz:
        out[..., min(geom.zs - 1, f.shape[nd - 1] - 1) if dz == 1 else 0] = fill
    return out


# ------------------------------------------------------------------- force
def grid3_force_xla(xl, yl, zl, geom: Geometry3S, coef_of, c2=None):
    """27-plane stencil force; ``coef_of(r2) -> coef`` is the force-law seam
    (``physics.coef_from_r2`` / ``lj_coef_from_r2`` partials). Sums in
    ``DIRS3`` order, then neighbour-slot order (name kept from the JAX
    package, whose twin is an XLA graph). With ``c2`` a fourth output
    counts, per slot, its pairs with ``r2 <= c2`` (itself included; a dead
    slot meets the dead slots of its bin too, so callers mask it out)."""
    ax = torch.zeros_like(xl)
    ay = torch.zeros_like(yl)
    az = torch.zeros_like(zl)
    hits = None if c2 is None else torch.zeros_like(xl, dtype=torch.int32)
    for dy, dx, dz in DIRS3:
        xn_all = _shifted3(xl, dy, dx, dz, geom)
        yn_all = _shifted3(yl, dy, dx, dz, geom)
        zn_all = _shifted3(zl, dy, dx, dz, geom)
        offx = f32(dx * geom.bsx)
        offy = f32(dy * geom.bsy)
        offz = f32(dz * geom.bsz)
        for j in range(geom.capacity):
            ddx = (xn_all[j:j + 1] + offx) - xl
            ddy = (yn_all[j:j + 1] + offy) - yl
            ddz = (zn_all[j:j + 1] + offz) - zl
            r2 = ddx * ddx + ddy * ddy + ddz * ddz
            coef = coef_of(r2)
            ax = ax + coef * ddx
            ay = ay + coef * ddy
            az = az + coef * ddz
            if hits is not None:
                hits += r2 <= c2
    return (ax, ay, az) if hits is None else (ax, ay, az, hits)


# -------------------------------------------------------------------- move
def _reflect(local, off, v, L: float):
    """Wall fold of ``local + off`` for out-of-box slots only;
    ``torch.remainder`` is floored like ``jnp.mod``."""
    g = local + off
    out = (g < 0.0) | (g > L)
    m = torch.remainder(g, 2.0 * L)
    local = torch.where(out, (L - torch.abs(m - L)) - off, local)
    v = torch.where(out & (m > L), -v, v)
    return local, v


def move3_planes(xl, yl, zl, vx, vy, vz, ax, ay, az, alive, geom: Geometry3S,
                 dt, size, y0=0):
    """Verlet + 3-axis wall reflection on slab planes (reference:
    part1/serial.cpp:44-61); empty slots stay at BIG with zero velocity.
    Returns the six planes and ``speed2``, the (cap, Y, X, Z) |v|^2 planes
    (0 on empty slots). ``y0`` is the global index of the planes' first y
    slab (a shard's offset): it enters the wall fold."""
    dtf = f32(dt)
    L = f32(size)
    vx = torch.where(alive, vx + ax * dtf, 0.0)
    vy = torch.where(alive, vy + ay * dtf, 0.0)
    vz = torch.where(alive, vz + az * dtf, 0.0)
    xl = xl + vx * dtf
    yl = yl + vy * dtf
    zl = zl + vz * dtf
    xo, yo, zo = _offsets(geom, xl.shape, xl.device, y0)
    xl, vx = _reflect(xl, xo, vx, L)
    yl, vy = _reflect(yl, yo, vy, L)
    zl, vz = _reflect(zl, zo, vz, L)
    xl = torch.where(alive, xl, BIG)
    yl = torch.where(alive, yl, BIG)
    zl = torch.where(alive, zl, BIG)
    speed2 = torch.where(alive, vx * vx + vy * vy + vz * vz, 0.0)
    return xl, yl, zl, vx, vy, vz, speed2


def grid3_move(state: Slab3State, accel, geom: Geometry3S, dt, size, y0=0):
    """Verlet + wall reflection on the 3D slab grid (``y0``: the global
    index of the first y slab); returns ``(new_state, max_speed scalar
    tensor)``."""
    *planes, speed2 = move3_planes(*state[:6], *accel, state.pid >= 0, geom,
                                   dt, size, y0)
    return Slab3State(*planes, state.pid), torch.sqrt(speed2.max())


# ------------------------------------------------------------------- rebin
def slab3_dirs(state: Slab3State, geom: Geometry3S, y0=0):
    """Per-slot movement direction per axis, clamped to one hop and to the
    physical grid, plus the far-move flag (a raw drift of more than one bin
    on any axis) and aliveness. Empty slots get 0. ``y0`` is the global
    index of the first y slab: the clamp at ``geom.ys`` reads global slabs
    (``geom.ys`` stays physical where a sharded engine pads ``ys_pad``)."""
    alive = state.pid >= 0
    zero = torch.zeros((), dtype=torch.int32, device=state.xl.device)

    def raw(local, bs):
        # dead slots hold BIG, whose quotient overflows int32: mask first
        return torch.where(alive, torch.floor(local * f32(1.0 / bs)), 0.0).to(torch.int32)

    dx_r = raw(state.xl, geom.bsx)
    dy_r = raw(state.yl, geom.bsy)
    dz_r = raw(state.zl, geom.bsz)
    far = alive & ((dx_r.abs() > 1) | (dy_r.abs() > 1) | (dz_r.abs() > 1))
    shape, dev = dx_r.shape, dx_r.device

    def clamp(d, dim, n_phys, i0=0):
        i = i0 + _iota(shape, dim, dev)
        d = torch.clamp(d, -1, 1)
        d = torch.minimum(torch.maximum(d, -torch.clamp(i, max=1)),
                          torch.clamp(n_phys - 1 - i, max=1))
        return torch.where(alive, d, zero)

    return (clamp(dy_r, 1, geom.ys, y0), clamp(dx_r, 2, geom.xs),
            clamp(dz_r, 3, geom.zs), far, alive)


def _axis_pass(state: Slab3State, geom: Geometry3S, evac_cap: int, axis: int,
               y0=0, counts_m=None):
    """One 1-D rebin pass along ``axis`` (0 = y, 1 = x, 2 = z): movers take
    one hop under the loss-free acceptance contract of
    ``grid_ops._axis_pass2`` (direction -1 first, ``evac_cap`` per direction,
    the destination's pre-pass free slots as budget; the e-th accepted
    entrant lands in the destination's empty slot of empty-rank off + e);
    rejected movers stay. Returns the new state. Counts are int32. ``y0``:
    the global index of the first y slab. ``counts_m``: the plane of -1
    movers per bin, the offset input of the +1 stream, where the caller
    holds it (by default counted from ``state``)."""
    cap = geom.capacity
    i32 = torch.int32
    bs = f32((geom.bsy, geom.bsx, geom.bsz)[axis])
    dy, dx, dz, _, alive = slab3_dirs(state, geom, y0)
    adir = (dy, dx, dz)[axis]

    def shift(f, d, fill):
        trip = [0, 0, 0]
        trip[axis] = d
        return _shifted3(f, *trip, geom, fill=fill)

    F = cap - alive.sum(dim=0, dtype=i32)
    fields = list(state[:6])
    coord = (1, 0, 2)[axis]  # the field of this axis's coordinate
    fields[coord] = fields[coord] - adir.to(torch.float32) * bs

    outs = [[f[s] for s in range(cap)] for f in state]
    is_empty = state.pid < 0
    empty_rank = torch.cumsum(is_empty.to(i32), dim=0, dtype=i32) - is_empty.to(i32)

    if counts_m is None:
        counts_m = (alive & (adir == -1)).sum(dim=0, dtype=i32)
    off_of = {-1: torch.zeros_like(F), 1: shift(counts_m, 1, 0)}
    for d in (-1, 1):
        mask = alive & (adir == d)
        off_at_dest = shift(off_of[d], d, 0)
        F_at_dest = shift(F, d, 0)
        # rank of each mover among its bin's movers toward d, in slot order
        ranks = torch.cumsum(mask.to(i32), dim=0, dtype=i32) - mask.to(i32)
        accepted = [mask[j] & (ranks[j] < evac_cap)
                    & (off_at_dest + ranks[j] < F_at_dest) for j in range(cap)]
        for j in range(cap):
            for k in range(7):
                outs[k][j] = torch.where(accepted[j], FILLS3[k], outs[k][j])
        for e in range(evac_cap):
            evac = [torch.full_like(F, FILLS3[k], dtype=torch.float32)
                    for k in range(6)]
            epid = torch.full_like(F, -1)
            for j in range(cap):
                sel = accepted[j] & (ranks[j] == e)
                for k in range(6):
                    evac[k] = torch.where(sel, fields[k][j], evac[k])
                epid = torch.where(sel, state.pid[j], epid)
            cpid = shift(epid, -d, -1)
            cflds = [shift(evac[k], -d, FILLS3[k]) for k in range(6)]
            valid = cpid >= 0
            idx = off_of[d] + e
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                for k in range(6):
                    outs[k][s] = torch.where(sel, cflds[k], outs[k][s])
                outs[6][s] = torch.where(sel, cpid, outs[6][s])
    return Slab3State(*(torch.stack(o) for o in outs))


def y_counts(state: Slab3State, geom: Geometry3S, y0=0):
    """int32 (3, Y, X, Z) planes ``[movers -1, alive, movers +1]`` of the
    y pass's directions (its acceptance inputs)."""
    dy, _, _, _, alive = slab3_dirs(state, geom, y0)
    i32 = torch.int32
    return torch.stack([(dy == -1).sum(dim=0, dtype=i32),
                        alive.sum(dim=0, dtype=i32),
                        (dy == 1).sum(dim=0, dtype=i32)])


def post_counts(state: Slab3State, geom: Geometry3S, y0=0):
    """int32 (2, Y, X, Z) planes ``[alive_post, resid]``: settled occupancy
    and the movers left after the rebin."""
    dy, dx, dz, _, alive = slab3_dirs(state, geom, y0)
    i32 = torch.int32
    resid = alive & ((dy != 0) | (dx != 0) | (dz != 0))
    return torch.stack([alive.sum(dim=0, dtype=i32), resid.sum(dim=0, dtype=i32)])


def rebin3_monitors(far_pre, alive_pre, post) -> RebinMonitors:
    """Rebin monitors from the per-bin count planes, summed in int64 (a
    float32 sum loses integer exactness past 2^24, below 20.97M):
    ``max_occupancy`` after the rebin, ``dropped`` = particles lost plus far
    movers, ``deferred`` = movers left."""
    alive_post, resid = post[0], post[1]
    lost = alive_pre.sum(dtype=torch.int64) - alive_post.sum(dtype=torch.int64)
    dropped = lost + far_pre.sum(dtype=torch.int64)
    return RebinMonitors(alive_post.max().to(torch.int32), dropped.to(torch.int32),
                         resid.sum(dtype=torch.int64).to(torch.int32))


def grid3_rebin_axes(state: Slab3State, geom: Geometry3S, evac_cap: int, y0=0):
    """Axis-factorized 3D rebin, x, z, then y pass (y last, as in the JAX
    package), with its monitors. Far movers are counted on the PRE-rebin
    state: each pass clamps to one hop, so afterwards a 2-bin drifter would
    look benign. ``y0``: the global index of the first y slab."""
    i32 = torch.int32
    _, _, _, far0, alive0 = slab3_dirs(state, geom, y0)
    for axis in (1, 2, 0):
        state = _axis_pass(state, geom, evac_cap, axis, y0)
    return state, rebin3_monitors(far0.sum(dim=0, dtype=i32),
                                  alive0.sum(dim=0, dtype=i32),
                                  post_counts(state, geom, y0))
