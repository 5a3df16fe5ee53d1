"""The sharded slab-grid engine ``sharded_grid`` (port of
:mod:`ppsim_tpu.engines.sharded_grid`, the JAX package's flagship path,
spatially sharded): the 2D main path split into P row strips over a 1-D
mesh (``engines/mesh.py``), each strip stepped by the shard forms of the
kernels.

- **force halo**: every step each strip's boundary bin row (xl, yl) goes
  to both neighbours and enters K1 as ghost rows (the static-shape
  replacement of the reference's ``MPI_Sendrecv`` of neighbour particles,
  part2/mpi.cpp:122-146);
- **migration**: the loss-free rebin decides every move from count planes
  and masks, so ghost rows of the fields (and, for dirs9, two ghost rows of
  the count stack) make cross-strip migration fall out of the same shuffle:
  both strips of a boundary evaluate the same predicates on the same
  exchanged rows, so a transfer needs no emigrant buffer and no handshake
  (K2 for ``grid_rebin_mode="axes"``; K7 + K8 for ``"dirs9"``);
- **monitors** are reduced across the strips (per-strip "lost" is transfer
  flux: only the sums mean anything), in int64.

``impl="cuda"`` (the default) runs the kernels' wrappers (the kernels on
CUDA tensors, their plain twins on CPU tensors); ``impl="plain"`` runs the
single-device engine's plain ops on each strip extended by ghost rows (the
JAX package's ``impl="xla"``). The rebin cadence is the statically
scheduled one of :class:`~ppsim_tpu_torch.engines.grid.GridEngine.step`.
"""

from __future__ import annotations

import dataclasses

import torch

from ppsim_tpu_torch.engines.base import register_engine
from ppsim_tpu_torch.engines.grid import GridCarry, GridEngine, seed_pack_monitors
from ppsim_tpu_torch.engines.mesh import field_halos, mesh_for
from ppsim_tpu_torch.ops import grid_ops
from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_cuda, rebin_counts_cuda, rebin_shuffle_cuda,
)
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, RebinMonitors, SlabState
from ppsim_tpu_torch.physics import accel_fn_for
from ppsim_tpu_torch.state import ParticleState

__all__ = ["ShardedGridEngine", "reduce_monitors"]


def reduce_monitors(mesh, cnt) -> RebinMonitors:
    """RebinMonitors from every local strip's [far_pre, alive_pre,
    alive_post, resid] planes (a stack of 4, planes of any shape): int64
    sums over the mesh (a float32 sum loses integer exactness past 2^24),
    occupancy the max over the mesh."""
    sums = mesh.psum([c.flatten(1).sum(dim=1, dtype=torch.int64) for c in cnt])
    occ = mesh.pmax([c[2].max() for c in cnt])
    far, before, after, resid = sums
    return RebinMonitors(occ.to(torch.int32), (before - after + far).to(torch.int32),
                         resid.to(torch.int32))


@register_engine
class ShardedGridEngine(GridEngine):
    """``sharded_grid`` on ``mesh`` (default: ``LocalMesh(shards)`` on
    ``device``, or, where ``WORLD_SIZE`` is set as under ``torchrun`` and no
    ``shards`` are asked for, :meth:`DistMesh.from_env`)."""

    name = "sharded_grid"
    # No drop-detected capacity escalation, as in the JAX engine: a run
    # under capacity fails loudly at check() instead.
    _capacity_retry = False
    # profiling.phase_times' variant seam: "move" or "rebin" skips that
    # phase (the JAX engine's trace-time flag).
    _phase_disable = None

    def __init__(self, config, device="cuda", shards=None, mesh=None,
                 impl: str = "cuda"):
        if impl not in ("cuda", "plain"):
            raise ValueError(f"unknown sharded_grid impl {impl!r} (cuda | plain)")
        mesh = mesh_for(device, shards) if mesh is None else mesh
        if mesh.shape[1] != 1:
            raise ValueError(f"sharded_grid runs on row strips, a (P, 1) mesh; "
                             f"got {mesh.shape} (sharded_tile cuts columns)")
        super().__init__(config, device=mesh.device)
        self.mesh = mesh
        self.P = mesh.size
        self.impl = impl
        base = self.geom
        # Strips of rows_local rows, a multiple of 8 (the JAX engine's
        # row-block padding, kept so that both packages pick one geometry).
        self.rows_local = -(-base.rows // (self.P * 8)) * 8
        self.geom = dataclasses.replace(base, rows_pad=self.P * self.rows_local)

    def row0(self, d: int) -> int:
        """Global row of shard ``d``'s first row."""
        return d * self.rows_local

    # ---- phases ------------------------------------------------------------
    def move_phase(self, shards):
        """Force + integrate on every strip; returns (shards, max_speed)."""
        mesh, cfg, geom = self.mesh, self.config, self.geom
        if self._phase_disable == "move":
            return shards, torch.zeros((), dtype=torch.float32, device=self.device)
        gx, gy = field_halos(mesh, shards, SLAB_FILLS, 1, 1, (0, 1))
        out, speed = [], []
        for s, d, (tx, bx), (ty, by) in zip(shards, mesh.shards, gx, gy):
            if self.impl == "plain":
                ax, ay = grid_ops.grid_force_xla(
                    torch.cat([tx, s.xl, bx], 1), torch.cat([ty, s.yl, by], 1),
                    geom, cfg.cutoff, cfg.min_r, cfg.mass, pair_fn=accel_fn_for(cfg))
                new, ms = grid_ops.grid_move(s, (ax[:, 1:-1], ay[:, 1:-1]), geom,
                                             cfg.dt, cfg.size, row0=self.row0(d))
                out.append(new)
                speed.append(ms)
            else:
                xl, yl, vx, vy, sp2 = grid_step_cuda(
                    s.xl, s.yl, s.vx, s.vy, geom, cfg.cutoff, cfg.min_r,
                    cfg.mass, cfg.dt, cfg.size, law=cfg.force_law,
                    law_params=cfg.law_params, row0=self.row0(d),
                    ghosts=(tx, ty, bx, by))
                out.append(SlabState(xl, yl, vx, vy, s.pid))
                speed.append(sp2.max())
        max_speed = mesh.pmax(speed)
        if self.impl != "plain":  # sqrt after the max: monotone, so the same
            max_speed = torch.sqrt(max_speed)
        return out, max_speed

    def rebin_of(self, shards):
        """The rebin of every strip with its cross-strip migration; returns
        (shards, RebinMonitors) reduced over the mesh."""
        mesh, cfg, geom, evac = self.mesh, self.config, self.geom, self.config.evac_capacity
        if self._phase_disable == "rebin":
            z = torch.zeros((), dtype=torch.int32, device=self.device)
            return shards, RebinMonitors(z, z, z)
        row0s = [self.row0(d) for d in mesh.shards]
        if self.impl == "plain":
            # two ghost rows of every field: a destination's acceptance needs
            # its full neighbourhood (the JAX engine's _local_rebin_xla)
            rebin = (grid_ops.grid_rebin_axes if cfg.grid_rebin_mode == "axes"
                     else grid_ops.grid_rebin)
            ghosts = field_halos(mesh, shards, SLAB_FILLS, 2, 2, range(5))
            out, cnt = [], []
            for i, (s, r0) in enumerate(zip(shards, row0s)):
                ext = SlabState(*(torch.cat([g[i][0], f, g[i][1]], 1)
                                  for f, g in zip(s, ghosts)))
                new_ext, _ = rebin(ext, geom, evac, row0=r0 - 2)
                new = SlabState(*(f[:, 2:-2].contiguous() for f in new_ext))
                out.append(new)
                cnt.append(grid_ops.monitor_planes(s, new, geom, r0))
        elif cfg.grid_rebin_mode == "axes":
            # K2's walk reads fields at rows -1..+1 and the x masks at +2:
            # one ghost row from above, and from below two of xl and pid and
            # one of the others
            ghosts = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1,
                                2 if k in (0, 4) else 1) for k in range(5)]
            res = [rebin_axes_call_cuda(s, geom, evac, row0=r0,
                                        field_ghosts=[g[i] for g in ghosts])
                   for i, (s, r0) in enumerate(zip(shards, row0s))]
            out, cnt = [r[0] for r in res], [r[1] for r in res]
        else:
            counts = [rebin_counts_cuda(s, geom, row0=r0) for s, r0 in zip(shards, row0s)]
            fghosts = field_halos(mesh, shards, SLAB_FILLS, 1, 1, range(5))
            cghosts = mesh.halo(counts, 0, 2, 2)
            res = [rebin_shuffle_cuda(s, c, geom, evac, row0=r0,
                                      field_ghosts=[g[i] for g in fghosts],
                                      count_ghosts=cghosts[i])
                   for i, (s, c, r0) in enumerate(zip(shards, counts, row0s))]
            out, cnt = [r[0] for r in res], [r[1] for r in res]
        return out, reduce_monitors(mesh, cnt)

    # ---- protocol ------------------------------------------------------------
    def init_carry(self, state: ParticleState) -> GridCarry:
        """Pack once on the full grid, then split the slab into the local
        shards (``GridCarry.slab`` holds them, a list of SlabState)."""
        slab, overflow = grid_ops.slab_from_particles(
            state.pos.to(self.device), state.vel.to(self.device), self.geom)
        parts = [self.mesh.split(f) for f in slab]
        shards = [SlabState(*fs) for fs in zip(*parts)]
        return GridCarry(shards, seed_pack_monitors(overflow, self.capacity))

    def full_slab(self, carry: GridCarry) -> SlabState:
        """The global slab gathered from the shards."""
        return SlabState(*(self.mesh.gather([s[k] for s in carry.slab])
                           for k in range(5)))

    def frame_of(self, carry: GridCarry) -> torch.Tensor:
        return grid_ops.slab_positions(self.full_slab(carry), self.geom,
                                       self.config.num_parts)

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid_ops.slab_to_particles(self.full_slab(carry), self.geom,
                                              self.config.num_parts)
        return ParticleState(pos, vel)
