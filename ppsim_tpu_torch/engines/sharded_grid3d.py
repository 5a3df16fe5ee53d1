"""The sharded 3D slab-grid engine ``sharded_grid3d`` (port of
:mod:`ppsim_tpu.engines.sharded_grid3d`): the stretch config's 3D slab grid
split into P y strips over a 1-D mesh (``engines/mesh.py``), each strip
stepped by the shard forms of the 3D kernels. The strip/halo design of the
2D ``sharded_grid`` turned into the 3D layout (the reference's MPI rows,
part2/mpi.cpp:258-294):

- **force halo**: every step each strip's boundary y slab of xl, yl and zl
  goes to both neighbours and enters K3 as ghost slabs;
- **migration**: the x and z passes of the rebin are slab-local, so K4 runs
  on each strip alone; its output's boundary slabs (the seven fields, one a
  side) and its count planes [m-, alive] (one slab above, two below) go to
  the neighbours, and K5's y pass on each strip reads them where it reads
  beyond its slabs. Both strips of a boundary evaluate the same predicates
  on the same exchanged slabs, so a transfer needs no emigrant buffer and
  no handshake;
- **monitors** are reduced across the strips (per-strip "lost" is transfer
  flux: only the sums mean anything), in int64.

``impl="cuda"`` (the default) runs the kernels' wrappers (the kernels on
CUDA tensors, their plain twins on CPU tensors); ``impl="plain"`` runs the
single-device engine's plain ops on each strip extended by ghost slabs, one
for the force and two for the rebin (the JAX package's ``impl="xla"``). The
rebin cadence is the statically scheduled one of
:meth:`~ppsim_tpu_torch.engines.grid.GridEngine.step`.
"""

from __future__ import annotations

import dataclasses

import torch

from ppsim_tpu_torch.engines.base import register_engine
from ppsim_tpu_torch.engines.grid import GridCarry
from ppsim_tpu_torch.engines.grid3d import Grid3DEngine, _coef_of
from ppsim_tpu_torch.engines.mesh import field_halos, mesh_for
from ppsim_tpu_torch.engines.sharded_grid import reduce_monitors
from ppsim_tpu_torch.ops import grid3d_ops
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda
from ppsim_tpu_torch.ops.cuda_rebin3 import (
    ALIVE_PRE, FAR_PRE, rebin3_inplane_cuda, rebin3_ypass_cuda,
)
from ppsim_tpu_torch.ops.grid3d_ops import FILLS3, Slab3State
from ppsim_tpu_torch.ops.grid_ops import RebinMonitors
from ppsim_tpu_torch.state import ParticleState

__all__ = ["ShardedGrid3DEngine"]


@register_engine
class ShardedGrid3DEngine(Grid3DEngine):
    """``sharded_grid3d`` on ``mesh`` (default: ``LocalMesh(shards)`` on
    ``device``, or, where ``WORLD_SIZE`` is set as under ``torchrun`` and no
    ``shards`` are asked for, :meth:`DistMesh.from_env`)."""

    name = "sharded_grid3d"
    # Drop-detected capacity escalation, as in the JAX engine: a capacity
    # change leaves the strips (ys_local, ys_pad) as they are.
    _capacity_retry = True
    # No capacity-phase repack, as in the JAX engine: its global pack
    # would run on the whole slab, not on the strips.
    _repack_ok = False
    # profiling.phase_times' variant seam: "move" or "rebin" skips that
    # phase (the JAX engine's trace-time flag).
    _phase_disable = None

    def __init__(self, config, device="cuda", shards=None, mesh=None,
                 impl: str = "cuda"):
        if impl not in ("cuda", "plain"):
            raise ValueError(f"unknown sharded_grid3d impl {impl!r} (cuda | plain)")
        mesh = mesh_for(device, shards) if mesh is None else mesh
        if mesh.shape[1] != 1:
            raise ValueError(f"sharded_grid3d runs on y strips, a (P, 1) mesh; "
                             f"got {mesh.shape}")
        super().__init__(config, device=mesh.device)
        self.mesh = mesh
        self.P = mesh.size
        self.impl = impl
        # Strips of ys_local slabs, at least the rebin halo of 2; only the
        # array extent grows, geom.ys stays physical (the clamp at the edge
        # never rebins a particle into a padding slab).
        self.ys_local = max(2, -(-self.geom.ys // self.P))
        self.geom = dataclasses.replace(self.geom, ys_pad=self.P * self.ys_local)

    def y0(self, d: int) -> int:
        """Global index of shard ``d``'s first y slab."""
        return d * self.ys_local

    # ---- phases ------------------------------------------------------------
    def move_phase(self, shards):
        """Force + integrate on every strip; returns (shards, max_speed)."""
        mesh, cfg, geom = self.mesh, self.config, self.geom
        if self._phase_disable == "move":
            return shards, torch.zeros((), dtype=torch.float32, device=self.device)
        gx, gy, gz = field_halos(mesh, shards, FILLS3, 1, 1, (0, 1, 2))
        out, speed = [], []
        for i, (s, d) in enumerate(zip(shards, mesh.shards)):
            (tx, bx), (ty, by), (tz, bz) = gx[i], gy[i], gz[i]
            if self.impl == "plain":
                ax, ay, az = grid3d_ops.grid3_force_xla(
                    torch.cat([tx, s.xl, bx], 1), torch.cat([ty, s.yl, by], 1),
                    torch.cat([tz, s.zl, bz], 1), geom, _coef_of(cfg))
                new, ms = grid3d_ops.grid3_move(
                    s, (ax[:, 1:-1], ay[:, 1:-1], az[:, 1:-1]), geom, cfg.dt,
                    cfg.size, y0=self.y0(d))
                out.append(new)
                speed.append(ms)
            else:
                *planes, sp2 = grid3_step_cuda(
                    *s[:6], geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt,
                    cfg.size, law=cfg.force_law, law_params=cfg.law_params,
                    y0=self.y0(d), ghosts=(tx, ty, tz, bx, by, bz),
                    counts=self.step_counts())
                out.append(Slab3State(*planes, s.pid))
                speed.append(sp2.max())
        max_speed = mesh.pmax(speed)
        if self.impl != "plain":  # sqrt after the max: monotone, so the same
            max_speed = torch.sqrt(max_speed)
        return out, max_speed

    def rebin_of(self, shards):
        """The rebin of every strip with its cross-strip migration; returns
        (shards, RebinMonitors) reduced over the mesh."""
        mesh, geom, evac = self.mesh, self.geom, self.config.evac_capacity
        if self._phase_disable == "rebin":
            z = torch.zeros((), dtype=torch.int32, device=self.device)
            return shards, RebinMonitors(z, z, z)
        y0s = [self.y0(d) for d in mesh.shards]
        if self.impl == "plain":
            # two ghost slabs of every field: a destination's acceptance
            # needs its full neighbourhood (the JAX engine's _local_move_rebin)
            ghosts = field_halos(mesh, shards, FILLS3, 2, 2, range(7))
            out, cnt = [], []
            for i, (s, y0) in enumerate(zip(shards, y0s)):
                ext = Slab3State(*(torch.cat([g[i][0], f, g[i][1]], 1)
                                   for f, g in zip(s, ghosts)))
                new_ext, _ = grid3d_ops.grid3_rebin_axes(ext, geom, evac, y0 - 2)
                new = Slab3State(*(f[:, 2:-2].contiguous() for f in new_ext))
                _, _, _, far, alive = grid3d_ops.slab3_dirs(s, geom, y0)
                i32 = torch.int32
                out.append(new)
                cnt.append(torch.cat([torch.stack([far.sum(dim=0, dtype=i32),
                                                   alive.sum(dim=0, dtype=i32)]),
                                      grid3d_ops.post_counts(new, geom, y0)]))
        else:
            # K4 on every strip, then its output's ghost slabs, then K5
            mids = [rebin3_inplane_cuda(s, geom, evac, y0) for s, y0 in zip(shards, y0s)]
            fh = field_halos(mesh, [m for m, _ in mids], FILLS3, 1, 1, range(7))
            ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
            out, cnt = [], []
            for i, ((m, c), y0) in enumerate(zip(mids, y0s)):
                new, post = rebin3_ypass_cuda(m, c, geom, evac, y0,
                                              field_ghosts=[h[i] for h in fh],
                                              count_ghosts=ch[i])
                out.append(new)
                cnt.append(torch.cat([c[FAR_PRE:ALIVE_PRE + 1], post]))
        return out, reduce_monitors(mesh, cnt)

    # ---- protocol ------------------------------------------------------------
    def init_carry(self, state: ParticleState) -> GridCarry:
        """Pack once on the full grid (with the single-device engine's spill
        and auto-raise), then split the slab into the local shards
        (``GridCarry.slab`` holds them, a list of Slab3State)."""
        carry = super().init_carry(state)
        parts = [self.mesh.split(f) for f in carry.slab]
        shards = [Slab3State(*fs) for fs in zip(*parts)]
        return GridCarry(shards, carry.monitors)

    def full_slab(self, carry: GridCarry) -> Slab3State:
        """The global slab gathered from the shards."""
        return Slab3State(*(self.mesh.gather([s[k] for s in carry.slab])
                            for k in range(7)))

    def frame_of(self, carry: GridCarry) -> torch.Tensor:
        return grid3d_ops.slab3_positions(self.full_slab(carry), self.geom,
                                          self.config.num_parts)

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid3d_ops.slab3_to_particles(self.full_slab(carry), self.geom,
                                                 self.config.num_parts)
        return ParticleState(pos, vel)
