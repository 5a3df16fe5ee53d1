"""Spatially sharded particle-list engine ``sharded`` (port of
:mod:`ppsim_tpu.engines.sharded`, the structural analog of the reference's
MPI engine, part2/mpi.cpp), on the shard mesh of ``engines/mesh.py``: P row
strips, in one process (``LocalMesh``) or one process a strip
(``DistMesh``).

- 1-D row-strip decomposition over x: strip d owns ``rows_per_shard`` bin
  rows (``get_particle_rank``, part2/mpi.cpp:47-51), plus one ghost bin row
  on each side (:54-59);
- every step each strip sorts its particles into its local bin grid and
  sends its boundary grid rows to both neighbours, which place them in
  their ghost rows (``communicate_with_neighbor_proc``, :122-146);
- after the move, emigrants are packed into fixed-capacity buffers in
  order, sent one hop, and landed in the receiver's free slots
  (``move_particle_cross_processor``, :230-253). A particle that crossed
  more than one strip hops one strip a step; in transit it stays out of
  the bin grids (it exerts and feels no force that step) and counts into
  the non-fatal ``deferred``. Only a full transfer buffer or slot pool
  loses particles: ``migrate_dropped``;
- saves gather by particle id (``gather_for_save``, :371-402).

Each strip carries a fixed pool of ``n_cap`` slots (``pid = -1``: empty,
position at ``BIG``); the per-step stable sort doubles as compaction.

Within a bin the particles keep the order the single-device ``binned``
engine gives them (the order of their previous bins, then of their previous
ranks), so a bin's pair terms are summed in the same order and ``sharded``
equals ``binned`` bitwise. Immigrants land in free slots, anywhere in the
pool, so each slot carries its ``origin`` (0: landed from the strip above
last step, 1: here before, 2: from the strip below) and the sort key is
(bin, origin, slot): the immigrants from above come from lower bins, so
they go first, those from below last. The JAX engine sorts by (bin, slot)
and parts from ``binned`` where an immigrant shares a bin with three or
more terms in range.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from ppsim_tpu_torch.engines.base import Engine, Monitors, register_engine
from ppsim_tpu_torch.engines.mesh import mesh_for
from ppsim_tpu_torch.ops.binning import (
    BIG, GridGeometry, bin_coord, build_grid, segment_ranks,
)
from ppsim_tpu_torch.ops.forces import stencil_accel
from ppsim_tpu_torch.physics import accel_fn_for, const_like, verlet_step
from ppsim_tpu_torch.state import ParticleState

__all__ = ["ShardedEngine", "ShardCarry"]


# a slot's origin: landed from the strip above last step, here before, or
# landed from the strip below
FROM_ABOVE, HERE, FROM_BELOW = 0, 1, 2


class ShardCarry(NamedTuple):
    """One (n_cap, 2) ``pos`` / ``vel``, (n_cap,) int32 ``pid`` and (n_cap,)
    int8 ``origin`` tensor a local shard (``mesh.shards`` order; pid -1 =
    empty slot) and the monitors, the same in every process."""

    pos: List[torch.Tensor]
    vel: List[torch.Tensor]
    pid: List[torch.Tensor]
    origin: List[torch.Tensor]
    monitors: Monitors


def _first(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` True entries of ``mask`` in order (the
    length of ``mask`` where fewer are True), with no host sync."""
    csum = torch.cumsum(mask, dim=0, dtype=torch.int64)
    want = torch.arange(1, k + 1, dtype=torch.int64, device=mask.device)
    return torch.searchsorted(csum, want)


def _set_rows(dst, idx, src):
    """``dst`` with rows ``idx`` set to ``src``; an ``idx`` of ``len(dst)``
    is dropped (JAX's ``.at[idx].set(src, mode="drop")``)."""
    buf = torch.cat([dst, dst[:1]])
    buf[idx] = src
    return buf[:-1]


@register_engine
class ShardedEngine(Engine):
    """``sharded`` on ``mesh`` (default: ``LocalMesh(shards)`` on ``device``,
    or, where ``WORLD_SIZE`` is set as under ``torchrun`` and no ``shards``
    are asked for, :meth:`DistMesh.from_env`)."""

    name = "sharded"
    # profiling.phase_times' variant seam (see OracleEngine); the migration
    # runs in every variant.
    _phase_disable = None

    def __init__(self, config, device="cuda", shards=None, mesh=None):
        mesh = mesh_for(device, shards) if mesh is None else mesh
        if mesh.shape[1] != 1:
            raise ValueError(f"sharded runs on row strips, a (P, 1) mesh; got {mesh.shape}")
        super().__init__(config, device=mesh.device)
        self.mesh = mesh
        self.P = mesh.size
        R = C = config.bins_per_side
        self.rows_per_shard = -(-R // self.P)
        self.global_rows = R  # physical rows; padded rows past R stay empty
        self.ncols = C
        # local grid: owned rows + 1 ghost row on each side
        self.local_geom = GridGeometry(nrows=self.rows_per_shard + 2, ncols=C,
                                       capacity=config.bin_capacity,
                                       bin_size=config.bin_size)
        # Particles occupy only ceil(R / rows_per_shard) strips: trailing
        # strips can own no physical row, so the pool is sized by the
        # occupied strips, not by num_parts / P.
        occupied = max(1, -(-self.global_rows // self.rows_per_shard))
        n_cap = int(math.ceil(config.num_parts / occupied * config.shard_slack))
        self.n_cap = max(8, -(-n_cap // 8) * 8)
        mc = config.migrate_capacity
        self.m_cap = int(mc) if mc else max(64, C * config.bin_capacity // 2)
        if 2 * self.m_cap > self.n_cap:
            self.m_cap = self.n_cap // 2

    # ------------------------------------------------------------------ init
    def init_carry(self, state: ParticleState) -> ShardCarry:
        """Each local strip takes the particles whose row it owns, in id
        order, into the front of its slot pool (raises if a strip holds more
        than ``n_cap``)."""
        cfg, dev = self.config, self.device
        pos, vel = state.pos.to(dev), state.vel.to(dev)
        r_g = torch.clamp((pos[:, 0] / const_like(cfg.bin_size, pos)).to(torch.int64),
                          0, self.global_rows - 1)
        owner = torch.clamp(r_g // self.rows_per_shard, 0, self.P - 1)
        out = ([], [], [], [])
        for d in self.mesh.shards:
            idx = torch.nonzero(owner == d).flatten()
            k = idx.shape[0]
            if k > self.n_cap:
                raise RuntimeError(f"strip {d} holds {k} particles > slot pool "
                                   f"{self.n_cap}; raise shard_slack")
            p = torch.full((self.n_cap, 2), BIG, dtype=pos.dtype, device=dev)
            v = torch.zeros((self.n_cap, 2), dtype=vel.dtype, device=dev)
            i = torch.full((self.n_cap,), -1, dtype=torch.int32, device=dev)
            p[:k], v[:k], i[:k] = pos[idx], vel[idx], idx.to(torch.int32)
            o = torch.full((self.n_cap,), HERE, dtype=torch.int8, device=dev)
            for lst, t in zip(out, (p, v, i, o)):
                lst.append(t)
        return ShardCarry(*out, Monitors.zeros(dev))

    # ------------------------------------------------------- per-shard step
    def _bin_strip(self, d, pos, vel, pid, origin):
        """Sort strip ``d``'s slots by local bin, then origin (out-of-strip
        slots, empties and far movers in transit, to the bin past the void
        bin, last) and build its grid; returns the sorted (pos, vel, pid,
        lrow, col), the grid and the count of in-strip slots (0-dim)."""
        geom, C, Rl = self.local_geom, self.ncols, self.rows_per_shard
        inv = 1.0 / self.config.bin_size
        r_loc = bin_coord(pos[:, 0], inv, self.global_rows) - d * Rl
        col = bin_coord(pos[:, 1], inv, C)
        in_strip = (pid >= 0) & (r_loc >= 0) & (r_loc < Rl)
        lrow = torch.where(in_strip, r_loc + 1, -1000)  # +1: the ghost row
        # The transit bin lies past the void bin, so build_grid keeps its
        # slots' real positions out of the grid: in the void bin they would
        # be phantom neighbours where the stencil expects BIG.
        bin_id = torch.where(in_strip, lrow * C + col, geom.num_bins + 1)
        key, order = torch.sort(bin_id * 3 + origin, stable=True)
        bin_id = key // 3
        pos, vel, pid, lrow, col = (t[order] for t in (pos, vel, pid, lrow, col))
        grid = build_grid(pos, bin_id, segment_ranks(bin_id), geom)
        return (pos, vel, pid, lrow, col), grid, in_strip.sum()

    def _pack(self, mask, pos, vel, pid):
        """The first ``m_cap`` rows of ``mask`` in order as a transfer
        buffer: ((m_cap, 4) pos|vel, (m_cap,) pid with -1 past the last
        emigrant) and the count that did not fit."""
        n = mask.shape[0]
        src = _first(mask, self.m_cap)
        ok = src < n
        src = torch.clamp(src, max=n - 1)
        buf = torch.where(ok[:, None], torch.cat([pos[src], vel[src]], dim=1), BIG)
        bpid = torch.where(ok, pid[src], -1)
        over = torch.clamp(mask.sum(dtype=torch.int32) - self.m_cap, min=0)
        return buf, bpid, over

    def step_carry(self, carry: ShardCarry) -> ShardCarry:
        cfg, mesh, geom = self.config, self.mesh, self.local_geom
        Rl, P = self.rows_per_shard, self.P
        row_slots = self.ncols * geom.capacity
        binned = [self._bin_strip(d, *s) for d, s in
                  zip(mesh.shards, zip(carry.pos, carry.vel, carry.pid, carry.origin))]

        # The transit tail (empties, far movers) has only the void bin for
        # neighbours, so its accelerations are zero without a gather (the
        # JAX engine gathers them, to the same zeros): the stencil covers
        # the in-strip slots alone, whose counts cost one wait a step.
        n_ins = torch.stack([b[2] for b in binned]).tolist()

        # ---- halo: boundary grid rows -> the neighbours' ghost rows --------
        firsts = [g.slot_pos[row_slots:2 * row_slots] for _, g, _ in binned]
        lasts = [g.slot_pos[Rl * row_slots:(Rl + 1) * row_slots] for _, g, _ in binned]
        tops, bots = mesh.exchange(lasts, firsts, BIG, 0)  # from d-1, from d+1

        off = self._phase_disable
        pair_fn = accel_fn_for(cfg)
        inv = 1.0 / cfg.bin_size
        moved, ups, dns, local = [], [], [], []
        for d, ((pos, vel, pid, lrow, col), grid, _), k, top, bot in zip(
                mesh.shards, binned, n_ins, tops, bots):
            slot_pos = grid.slot_pos
            slot_pos[:row_slots] = top
            slot_pos[(Rl + 1) * row_slots:(Rl + 2) * row_slots] = bot
            alive = pid >= 0
            # ---- forces + move ---------------------------------------------
            accel = torch.zeros_like(pos)
            if off not in ("force", "force+move"):
                accel[:k] = stencil_accel(pos[:k], lrow[:k], col[:k], slot_pos, geom,
                                          cfg.cutoff, cfg.min_r, cfg.mass, pair_fn=pair_fn)
            if off != "force+move":
                mpos, mvel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)
                pos = torch.where(alive[:, None], mpos, pos)
                vel = torch.where(alive[:, None], mvel, vel)
            # ---- emigrants: one hop toward the owner -----------------------
            owner = torch.clamp(bin_coord(pos[:, 0], inv, self.global_rows) // Rl, 0, P - 1)
            delta = owner - d
            far = alive & (delta.abs() > 1)
            go_up, go_down = alive & (delta < 0), alive & (delta > 0)
            ups.append(self._pack(go_up, pos, vel, pid))
            dns.append(self._pack(go_down, pos, vel, pid))
            left = go_up | go_down
            moved.append((torch.where(left[:, None], BIG, pos),
                          torch.where(left[:, None], 0.0, vel),
                          torch.where(left, -1, pid)))
            local.append((grid.max_count, far.sum(dtype=torch.int32)))

        # the up buffer travels to d-1, the down buffer to d+1
        in_a, in_b = mesh.exchange([b[0] for b in dns], [b[0] for b in ups], BIG, 0)
        pid_a, pid_b = mesh.exchange([b[1] for b in dns], [b[1] for b in ups], -1, 0)

        m = self.m_cap
        inc_origin = torch.cat([torch.full((m,), FROM_BELOW, dtype=torch.int8, device=self.device),
                                torch.full((m,), FROM_ABOVE, dtype=torch.int8, device=self.device)])
        pos_out, vel_out, pid_out, origin_out, drops = [], [], [], [], []
        for (pos, vel, pid), ba, bb, ia, ib, up, dn in zip(
                moved, in_a, in_b, pid_a, pid_b, ups, dns):
            inc = torch.cat([bb, ba])
            inc_pid = torch.cat([ib, ia])
            # compact the incoming (valid first), then land them in the
            # first free slots
            vorder = torch.sort((inc_pid < 0).to(torch.uint8), stable=True).indices
            inc, inc_pid = inc[vorder], inc_pid[vorder]
            n_in = (inc_pid >= 0).sum(dtype=torch.int32)
            is_empty = pid < 0
            n_empty = is_empty.sum(dtype=torch.int32)
            m2 = inc_pid.shape[0]
            tgt = _first(is_empty, m2)
            ok = (inc_pid >= 0) & (torch.arange(m2, device=pid.device) < n_empty)
            tgt = torch.where(ok, tgt, pid.shape[0])  # dropped
            pos_out.append(_set_rows(pos, tgt, inc[:, :2]))
            vel_out.append(_set_rows(vel, tgt, inc[:, 2:]))
            pid_out.append(_set_rows(pid, tgt, inc_pid))
            here = torch.full(pid.shape, HERE, dtype=torch.int8, device=pid.device)
            origin_out.append(_set_rows(here, tgt, inc_origin[vorder]))
            drops.append(up[2] + dn[2] + torch.clamp(n_in - n_empty, min=0))

        # ---- monitors (the same in every process) -------------------------
        # Far movers are not losses: they hop a strip a step and converge
        # (deferred, non-fatal); only buffer or pool overflow drops.
        mon = carry.monitors
        monitors = Monitors(
            torch.maximum(mon.max_bin_count, mesh.pmax([c for c, _ in local])),
            mon.migrate_dropped + mesh.psum(drops),
            mon.max_speed,
            mon.deferred + mesh.psum([f for _, f in local]))
        return ShardCarry(pos_out, vel_out, pid_out, origin_out, monitors)

    # ----------------------------------------------------------- driver API
    def _id_gather(self, pid, values):
        """(num_parts, k) ``values`` of all shards in id order (every
        process gets the whole)."""
        n = self.config.num_parts
        pids = self.mesh.gather([p[None, :, None] for p in pid])[0, :, 0]
        vals = self.mesh.gather([v[None] for v in values])[0]
        out = torch.zeros((n + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device)
        out[torch.where(pids >= 0, pids, n)] = vals
        return out[:n]

    def frame_of(self, carry: ShardCarry) -> torch.Tensor:
        return self._id_gather(carry.pid, carry.pos)

    def final_state(self, carry: ShardCarry) -> ParticleState:
        return ParticleState(self._id_gather(carry.pid, carry.pos),
                             self._id_gather(carry.pid, carry.vel))
