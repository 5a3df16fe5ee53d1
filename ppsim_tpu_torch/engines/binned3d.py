"""3D cell-list engine, the stretch config's dimension on the particle list
(port of :mod:`ppsim_tpu.engines.binned3d`).

The sort-based cell list of ``binned`` in three dimensions: cells of side
``bin_size >= cutoff`` on an (nx, ny, nz) grid, the 3x3 stencil becomes
3x3x3 (27 gathers), and the capacity-padded slot grid is the neighbour list,
rebuilt every step. Both force laws plug in through
``physics.accel_vec_fn_for``; the oracle (``ndim=3``) is its ground truth.
"""

from __future__ import annotations

import dataclasses

import torch

from ppsim_tpu_torch.engines.base import Carry, Engine, register_engine
from ppsim_tpu_torch.engines.binned import grid_monitors
from ppsim_tpu_torch.ops.binning import bin_coord, build_grid, sort_by_bin
from ppsim_tpu_torch.ops.forces import slot_sum
from ppsim_tpu_torch.physics import accel_vec_fn_for, verlet_step

__all__ = ["Binned3DEngine", "Geometry3D"]


@dataclasses.dataclass(frozen=True)
class Geometry3D:
    """Static 3D cell-grid geometry (duck-typed for ``build_grid``)."""

    nx: int
    ny: int
    nz: int
    capacity: int
    bin_size: float

    @property
    def num_bins(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def num_slots(self) -> int:
        return (self.num_bins + 1) * self.capacity

    @classmethod
    def cube(cls, config) -> "Geometry3D":
        n = config.bins_per_side
        return cls(nx=n, ny=n, nz=n, capacity=config.bin_capacity,
                   bin_size=config.bin_size)


@register_engine
class Binned3DEngine(Engine):
    name = "binned3d"
    supported_ndim = (3,)

    # profiling.phase_times' variant seam (see OracleEngine).
    _phase_disable = None

    def __init__(self, config, device="cuda"):
        super().__init__(config, device=device)
        self.geom = Geometry3D.cube(config)

    def step_carry(self, carry: Carry) -> Carry:
        cfg, geom = self.config, self.geom
        inv = 1.0 / geom.bin_size
        bx = bin_coord(carry.pos[:, 0], inv, geom.nx)
        by = bin_coord(carry.pos[:, 1], inv, geom.ny)
        bz = bin_coord(carry.pos[:, 2], inv, geom.nz)
        bin_id = (bx * geom.ny + by) * geom.nz + bz

        order, sorted_id, rank = sort_by_bin(bin_id)
        pos = carry.pos[order]
        vel = carry.vel[order]
        pid = carry.pid[order]
        bx, by, bz = bx[order], by[order], bz[order]

        grid = build_grid(pos, sorted_id, rank, geom)
        cap_iota = torch.arange(geom.capacity, device=pos.device)[None, :]

        accel_vec = accel_vec_fn_for(cfg)
        accel = torch.zeros_like(pos)
        off = self._phase_disable
        stencil = () if off in ("force", "force+move") else (-1, 0, 1)
        for dxb in stencil:
            for dyb in (-1, 0, 1):
                for dzb in (-1, 0, 1):
                    nxb, nyb, nzb = bx + dxb, by + dyb, bz + dzb
                    valid = ((nxb >= 0) & (nxb < geom.nx) & (nyb >= 0) & (nyb < geom.ny)
                             & (nzb >= 0) & (nzb < geom.nz))
                    # out of the grid: the void bin, BIG everywhere
                    nb = torch.where(valid, (nxb * geom.ny + nyb) * geom.nz + nzb,
                                     geom.num_bins)
                    npos = grid.slot_pos[nb[:, None] * geom.capacity + cap_iota]
                    accel = accel + slot_sum(accel_vec(npos - pos[:, None, :]))

        if off != "force+move":
            pos, vel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)
        return Carry(pos, vel, pid, carry.monitors.merge(grid_monitors(grid.max_count)))
