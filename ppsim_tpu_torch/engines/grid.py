"""Slab-grid engines (port of :mod:`ppsim_tpu.engines.grid`).

``grid`` — the slab-grid engine in plain PyTorch on any device (the
           correctness twin).
``cuda`` — the same engine with the Hopper kernels on the hot path: the fused
           step K1 (``ops/cuda_grid.py``) every step and the rebin
           (``ops/cuda_rebin.py``: K2 for ``grid_rebin_mode="axes"``, K7 +
           K8 for ``"dirs9"``) every ``rebin_every``-th step; ``accel_of``,
           the force-only API, runs K6. On a CPU device its wrappers run
           their plain twins.

Step structure: force + move (with the per-bin speed plane) every step;
every ``rebin_every``-th step also the loss-free rebin: the
axis-factorized one (default) or the 9-direction shuffle (``dirs9``).
Between rebins the binning is stale; correct while the accumulated drift
stays under ``(bin_side - cutoff)/2``, which ``check`` verifies from the
``max_speed`` monitor.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from ppsim_tpu_torch.engines.base import (
    MAX_DEVICE_FRAME_BYTES, Engine, Monitors, register_engine,
)
from ppsim_tpu_torch.ops import grid_ops
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry, SlabState
from ppsim_tpu_torch.state import ParticleState

__all__ = ["GridEngine", "CudaGridEngine", "GridCarry", "seed_pack_monitors",
           "require_slab_modes"]


class GridCarry(NamedTuple):
    slab: SlabState
    monitors: Monitors


def seed_pack_monitors(overflow, capacity: int) -> Monitors:
    """Initial monitors carrying the packer's overflow count as a device
    tensor: ``max_bin_count`` is seeded with ``capacity + overflow`` whenever
    overflow > 0, so ``check()`` raises "bin overflow" after the run without
    a device-to-host wait in the timed region."""
    seeded = torch.where(overflow > 0, capacity + overflow, 0).to(torch.int32)
    z = Monitors.zeros(overflow.device)
    return z._replace(max_bin_count=seeded)


def require_slab_modes(config) -> None:
    """The slab-grid family runs float32 with the sort pack and either rebin
    mode (``axes`` or ``dirs9``)."""
    if config.dtype != "float32":
        raise ValueError("the slab-grid engine family is float32-only")
    if config.grid_rebin_mode not in ("axes", "dirs9"):
        raise ValueError(f"unknown grid_rebin_mode {config.grid_rebin_mode!r}")
    if config.grid_pack_mode != "sort":
        raise ValueError("the port implements grid_pack_mode='sort' only")


@register_engine
class GridEngine(Engine):
    name = "grid"

    def __init__(self, config, device="cuda"):
        super().__init__(config, device=device)
        require_slab_modes(config)
        self.geom = SlabGeometry.for_config(config)

    @property
    def capacity(self) -> int:
        # The chosen geometry's capacity (under grid_snap_lanes it follows
        # the snapped occupancy, not config.grid_capacity).
        return self.geom.capacity

    @property
    def rebin_every(self) -> int:
        return self.config.rebin_every

    def check(self, result) -> None:
        """Monitors gate with the chosen geometry's capacity and slack."""
        cfg = self.config
        mx = int(result.monitors.max_bin_count)
        if mx > self.capacity:
            raise RuntimeError(
                f"bin overflow: max occupancy {mx} > capacity {self.capacity}"
            )
        if int(result.monitors.migrate_dropped):
            raise RuntimeError(
                f"{int(result.monitors.migrate_dropped)} particles dropped; "
                "increase evac_capacity"
            )
        drift = cfg.rebin_every * float(result.monitors.max_speed) * cfg.dt
        slack = (self.geom.bin_size - cfg.cutoff) / 2.0
        if drift > slack:
            raise RuntimeError(
                f"stale-bin slack violated: rebin_every*max|v|*dt = "
                f"{drift:.4g} > slack {slack:.4g}; lower rebin_every or "
                "raise grid_bin_scale"
            )

    # ---- phases (the cuda engine overrides all three) ----------------------
    def accel_of(self, xl, yl):
        """Accelerations ``(ax, ay)`` of the slab positions (the force-only
        API)."""
        from ppsim_tpu_torch.physics import accel_fn_for

        cfg = self.config
        return grid_ops.grid_force_xla(
            xl, yl, self.geom, cfg.cutoff, cfg.min_r, cfg.mass,
            pair_fn=accel_fn_for(cfg))

    def move_phase(self, slab: SlabState):
        """Force + integrate; returns (new_slab, max_speed)."""
        cfg = self.config
        accel = self.accel_of(slab.xl, slab.yl)
        return grid_ops.grid_move(slab, accel, self.geom, cfg.dt, cfg.size)

    def rebin_of(self, slab: SlabState):
        fn = (grid_ops.grid_rebin_axes if self.config.grid_rebin_mode == "axes"
              else grid_ops.grid_rebin)
        return fn(slab, self.geom, self.config.evac_capacity)

    # ---- drop-detected capacity escalation -------------------------------
    # Auto-capacity runs self-heal: a run that dropped particles (or whose
    # initial packing overflowed) raises capacity and re-runs from the
    # initial state (Engine.run below and harness.timed_run, bounded
    # retries). A hand grid_capacity never retries; nor does an engine that
    # sets _capacity_retry False (sharded_grid, as in the JAX package).
    _capacity_retry = True
    _DROP_RETRIES = 2

    def maybe_escalate_after_drop(self, result) -> bool:
        if self.config.grid_capacity is not None or not self._capacity_retry:
            return False
        dropped = int(result.monitors.migrate_dropped)
        packing = int(result.monitors.max_bin_count)
        if dropped == 0 and packing <= self.geom.capacity:
            return False
        new_cap = max(self.geom.capacity + 1, packing)
        print(
            f"{self.name}: run dropped {dropped} particle(s) / packed "
            f"{packing} at capacity {self.geom.capacity}; escalating to "
            f"{new_cap} and re-running from the initial state",
            file=sys.stderr)
        self.geom = dataclasses.replace(self.geom, capacity=new_cap)
        return True

    def run(self, state: ParticleState, nsteps=None, savefreq: int = 0,
            max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES):
        steps_before = self.counters.steps_run
        result = super().run(state, nsteps, savefreq, max_device_frame_bytes)
        for _try in range(self._DROP_RETRIES):
            if not self.maybe_escalate_after_drop(result):
                break
            self.counters.note_rerun(steps_before)
            steps_before = self.counters.steps_run
            self._rerunning = True
            try:
                result = super().run(state, nsteps, savefreq, max_device_frame_bytes)
            finally:
                self._rerunning = False
        return result

    # ---- protocol ----------------------------------------------------------
    def init_carry(self, state: ParticleState) -> GridCarry:
        slab, overflow = grid_ops.slab_from_particles(
            state.pos.to(self.device), state.vel.to(self.device), self.geom)
        return GridCarry(slab, seed_pack_monitors(overflow, self.capacity))

    def step_plain(self, carry: GridCarry) -> GridCarry:
        slab, max_speed = self.move_phase(carry.slab)
        monitors = carry.monitors._replace(
            max_speed=torch.maximum(carry.monitors.max_speed, max_speed))
        return GridCarry(slab, monitors)

    def step_with_rebin(self, carry: GridCarry) -> GridCarry:
        slab, max_speed = self.move_phase(carry.slab)
        slab, rmon = self.rebin_of(slab)
        monitors = carry.monitors.merge(
            Monitors(rmon.max_occupancy, rmon.dropped, max_speed, rmon.deferred))
        return GridCarry(slab, monitors)

    def step(self, carry: GridCarry, i: int) -> GridCarry:
        """Rebins land on global steps i = K, 2K, ... (the JAX package's
        statically scheduled cadence)."""
        if i % self.rebin_every == 0:
            return self.step_with_rebin(carry)
        return self.step_plain(carry)

    def frame_of(self, carry: GridCarry) -> torch.Tensor:
        return grid_ops.slab_positions(carry.slab, self.geom,
                                       self.config.num_parts)

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid_ops.slab_to_particles(carry.slab, self.geom,
                                              self.config.num_parts)
        return ParticleState(pos, vel)


@register_engine
class CudaGridEngine(GridEngine):
    """The slab-grid engine on the Hopper kernels (the JAX package's
    ``pallas`` engine): ``move_phase`` runs K1, ``accel_of`` K6, and
    ``rebin_of`` K2 (``axes``) or K7 + K8 (``dirs9``)."""

    name = "cuda"

    def accel_of(self, xl, yl):
        from ppsim_tpu_torch.ops.cuda_grid import grid_force_cuda

        cfg = self.config
        return grid_force_cuda(xl, yl, self.geom, cfg.cutoff, cfg.min_r,
                               cfg.mass, law=cfg.force_law,
                               law_params=cfg.law_params)

    def move_phase(self, slab: SlabState):
        from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda

        cfg = self.config
        xl, yl, vx, vy, speed2 = grid_step_cuda(
            slab.xl, slab.yl, slab.vx, slab.vy, self.geom,
            cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size,
            law=cfg.force_law, law_params=cfg.law_params)
        # sqrt of the max of the per-bin |v|^2 plane (order-free, so equal to
        # the reduction over the full slabs)
        return SlabState(xl, yl, vx, vy, slab.pid), torch.sqrt(speed2.max())

    def rebin_of(self, slab: SlabState):
        from ppsim_tpu_torch.ops.cuda_rebin import grid_rebin_axes_cuda, grid_rebin_cuda

        fn = (grid_rebin_axes_cuda if self.config.grid_rebin_mode == "axes"
              else grid_rebin_cuda)
        return fn(slab, self.geom, self.config.evac_capacity)
