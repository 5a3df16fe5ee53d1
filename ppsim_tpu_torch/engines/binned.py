"""Single-device binned engine: sort-rebin + stencil forces every step (port
of :mod:`ppsim_tpu.engines.binned`, the JAX CLI's default engine).

- rebin every step (part1/vecmp.cpp:88-123): a stable sort by bin and a
  segmented rank assign the slots, the lock-free analog of the reference's
  per-bin locks (part1/openmp.cpp) and CUDA ``atomicAdd`` (part3/gpu.cu:109);
- the 3x3 stencil gather over the capacity-padded grid
  (part1/serial.cpp:102-117, part3/gpu.cu:115-142), ``ops/forces.py``.

Particles stay bin-sorted across steps (identity in ``carry.pid``): each
step's sort input is nearly sorted and the gathers touch near-contiguous
slots. This is the reference CUDA engine's gather layout; the slab engines
(``grid``, ``cuda``) keep the state on the bin grid instead.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch.engines.base import Carry, Engine, Monitors, register_engine
from ppsim_tpu_torch.ops.binning import GridGeometry, bin_ids_of, build_grid, sort_by_bin
from ppsim_tpu_torch.ops.forces import stencil_accel
from ppsim_tpu_torch.physics import accel_fn_for, verlet_step

__all__ = ["BinnedEngine", "grid_monitors"]


def grid_monitors(max_count) -> Monitors:
    """A step's monitors of the binned engines: the grid's max occupancy,
    nothing dropped, no speed tracked, nothing deferred."""
    z = torch.zeros((), dtype=torch.int32, device=max_count.device)
    return Monitors(max_count, z, torch.zeros((), dtype=torch.float32,
                                              device=max_count.device), z)


@register_engine
class BinnedEngine(Engine):
    name = "binned"

    # profiling.phase_times' variant seam (see OracleEngine).
    _phase_disable = None

    def __init__(self, config, device="cuda"):
        super().__init__(config, device=device)
        self.geom = GridGeometry.square(config)

    def accel_of(self, pos_sorted, row, col, grid):
        """The force phase (a hook, as in the JAX engine)."""
        cfg = self.config
        return stencil_accel(pos_sorted, row, col, grid.slot_pos, self.geom,
                             cfg.cutoff, cfg.min_r, cfg.mass, pair_fn=accel_fn_for(cfg))

    def step_carry(self, carry: Carry) -> Carry:
        cfg, geom = self.config, self.geom
        _, _, bin_id = bin_ids_of(carry.pos, geom)
        order, sorted_id, rank = sort_by_bin(bin_id)
        pos = carry.pos[order]
        vel = carry.vel[order]
        pid = carry.pid[order]

        grid = build_grid(pos, sorted_id, rank, geom)
        row = sorted_id // geom.ncols
        col = sorted_id - row * geom.ncols

        off = self._phase_disable
        if off in ("force", "force+move"):
            accel = torch.zeros_like(pos)
        else:
            accel = self.accel_of(pos, row, col, grid)
        if off != "force+move":
            pos, vel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)
        return Carry(pos, vel, pid, carry.monitors.merge(grid_monitors(grid.max_count)))
