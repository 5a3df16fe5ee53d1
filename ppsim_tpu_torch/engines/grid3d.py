"""3D slab-grid engines (port of :mod:`ppsim_tpu.engines.grid3d`): the
stretch config, BASELINE.json ``configs[4]`` (3D Lennard-Jones, n = 20M).

``grid3d`` — the 3D slab-grid engine in plain PyTorch on any device (the
             correctness twin of the JAX ``grid3d``).
``cuda3d`` — the same engine on the Hopper kernels (the JAX ``pallas3d``):
             K3 (``ops/cuda_grid3.py``) every step and K4 + K5
             (``ops/cuda_rebin3.py``) every ``rebin_every``-th step. On a CPU
             device its wrappers run their plain twins.

The 2D slab engine's run driver, monitors and save path carry over (fields
are ``(capacity, Y, X, Z)``, ``ops/grid3d_ops.py``); the rebin cadence is
``rebin3_every`` or the chosen geometry's auto cadence. The initial pack
spills or auto-raises when the t = 0 lattice overflows, and an auto-capacity
run that drops particles escalates and re-runs. When the pack raised the
capacity, the timed runs (``harness.timed_run_repeats``) take a prologue
at that packing capacity and then repack the slab down to the run capacity
(``repack_plan`` / ``attempt_repack`` / ``commit_repack``): on by default for
the repulsive law, off for LJ, whose run outgrows its packing.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch

from ppsim_tpu_torch.engines.base import Engine, register_engine
from ppsim_tpu_torch.engines.grid import GridCarry, GridEngine, seed_pack_monitors
from ppsim_tpu_torch.ops import grid3d_ops
from ppsim_tpu_torch.ops.grid3d_ops import Geometry3S, Slab3State
from ppsim_tpu_torch.state import ParticleState

__all__ = ["Grid3DEngine", "Cuda3DEngine"]


def _coef_of(config):
    """The force-law seam: ``coef(r2)`` of the config's law."""
    from ppsim_tpu_torch.physics import coef_from_r2, lj_coef_from_r2

    if config.force_law == "lj":
        return functools.partial(
            lj_coef_from_r2, cutoff=config.cutoff, min_r=config.min_r,
            mass=config.mass, epsilon=config.lj_epsilon, sigma=config.lj_sigma)
    return functools.partial(coef_from_r2, cutoff=config.cutoff,
                             min_r=config.min_r, mass=config.mass)


@register_engine
class Grid3DEngine(GridEngine):
    name = "grid3d"
    supported_ndim = (3,)

    # Run-tail headroom on top of the measured initial packing, keyed on the
    # force law (the JAX package's measured run maxima: the repulsive law
    # never exceeds its lattice packing, LJ clusters one slot past it).
    _TAIL_SLOTS = {"repulsive": 0, "lj": 1}
    # Capacity-phase repack: the sharded 3D engine opts out (the repack's
    # global pack would not know its strips).
    _repack_ok = True
    # The first attempt (steps), when config.grid3_prologue_steps is None,
    # and the last step a failed attempt may retry at. The repulsive
    # dynamics disperse the t = 0 lattice slowly: the JAX package measured
    # a by-position demand above the packing capacity at step 40 of the
    # n = 20.97M run, so the window is wide.
    _REPACK_MIN_STEPS = 40
    _REPACK_MAX_STEPS = 480

    def __init__(self, config, device="cuda"):
        Engine.__init__(self, config, device=device)  # no 2D geometry
        if config.dtype != "float32":
            raise ValueError("the slab-grid engine family is float32-only")
        if config.grid_pack_mode != "sort":
            raise ValueError("the port implements grid_pack_mode='sort' only")
        self.geom = Geometry3S.for_config(config)
        self._pack_capacity = None  # known after the first init_carry
        self._pack_spill = False
        self._escalated_floor = 0  # the capacity a drop escalated to

    @property
    def rebin_every(self) -> int:
        # the auto cadence follows the chosen geometry's tightest axis
        return self.geom.cadence(self.config)

    def _slack(self) -> float:
        g = self.geom
        return (min(g.bsx, g.bsy, g.bsz) - self.config.cutoff) / 2.0

    def check(self, result) -> None:
        """Monitors gate: occupancy against the largest capacity of the run,
        no drops, drift within the tightest axis's slack."""
        cfg = self.config
        mx = int(result.monitors.max_bin_count)
        cap = max(self.capacity, self._pack_capacity or 0)
        if mx > cap:
            raise RuntimeError(f"bin overflow: max occupancy {mx} > capacity {cap}")
        if int(result.monitors.migrate_dropped):
            raise RuntimeError(
                f"{int(result.monitors.migrate_dropped)} particles dropped")
        drift = self.rebin_every * float(result.monitors.max_speed) * cfg.dt
        if drift > self._slack():
            raise RuntimeError(
                f"stale-bin slack violated: {drift:.4g} > {self._slack():.4g}; "
                "lower rebin3_every or raise grid3_bin_scale")

    # ---- phases (the cuda3d engine overrides these two) --------------------
    def move_phase(self, slab: Slab3State):
        cfg = self.config
        accel = grid3d_ops.grid3_force_xla(slab.xl, slab.yl, slab.zl,
                                           self.geom, _coef_of(cfg))
        return grid3d_ops.grid3_move(slab, accel, self.geom, cfg.dt, cfg.size)

    def rebin_of(self, slab: Slab3State):
        return grid3d_ops.grid3_rebin_axes(slab, self.geom,
                                           self.config.evac_capacity)

    # ---- initial pack: spill or auto-raise ---------------------------------
    def _set_capacity(self, new_cap: int) -> None:
        self.geom = dataclasses.replace(self.geom, capacity=new_cap)

    def _spill_enabled(self) -> bool:
        if self.config.grid3_spill is not None:
            return self.config.grid3_spill
        # auto: only with auto capacity (hand capacities observe the raise)
        return self.config.grid3_capacity is None

    def _spill_depth(self) -> float:
        """Largest face distance a spilled particle may sit from its
        residence bin: the stale-bin slack less the drift before the first
        rebin at the cadence chooser's speed bound."""
        cfg = self.config
        drift = (self.rebin_every * grid3d_ops._VMAX_TAIL * cfg.grid3_vmax
                 * cfg.dt)
        return max(0.0, self._slack() - drift)

    def _pack(self, pos, vel, spill: bool):
        if spill:
            slab, overflow, _ = grid3d_ops.slab3_from_particles_spill(
                pos, vel, self.geom, self._spill_depth())
            return slab, overflow
        return grid3d_ops.slab3_from_particles(pos, vel, self.geom)

    def init_carry(self, state: ParticleState) -> GridCarry:
        pos = state.pos.to(self.device)
        vel = state.vel.to(self.device)
        if self._pack_capacity is not None:
            # every later call: pack at the known capacity, no host wait (the
            # overflow still rides the monitors)
            if self.geom.capacity != self._pack_capacity:
                self._set_capacity(self._pack_capacity)
            slab, overflow = self._pack(pos, vel, self._pack_spill)
            return GridCarry(slab, seed_pack_monitors(overflow, self.capacity))

        # first call (the warm-up of the timed drivers): measure the packing
        slab, overflow = self._pack(pos, vel, False)
        if int(overflow):
            packing = self.capacity + int(overflow)
            if self._spill_enabled() and self._spill_depth() > 0.0:
                slab2, ovf2, spilled = grid3d_ops.slab3_from_particles_spill(
                    pos, vel, self.geom, self._spill_depth())
                if int(ovf2) == 0:
                    print(f"{self.name}: initial packing {packing} exceeds "
                          f"capacity {self.capacity}; spilled {int(spilled)} "
                          "boundary particle(s) to adjacent bins instead of "
                          "raising capacity", file=sys.stderr)
                    self._pack_spill = True
                    self._pack_capacity = self.geom.capacity
                    return GridCarry(slab2, seed_pack_monitors(ovf2, self.capacity))
            new_cap = packing + self._TAIL_SLOTS.get(self.config.force_law, 1)
            print(f"{self.name}: initial packing {packing} exceeds capacity "
                  f"{self.capacity}; auto-raising capacity to {new_cap}",
                  file=sys.stderr)
            self._set_capacity(new_cap)
            slab, overflow = self._pack(pos, vel, False)
            assert int(overflow) == 0  # the packing was measured exactly
        self._pack_capacity = self.geom.capacity
        return GridCarry(slab, seed_pack_monitors(overflow, self.capacity))

    # ---- capacity-phase repack ---------------------------------------------
    # The t = 0 lattice can pack one slot past the capacity the run needs
    # (n = 20.97M 3D repulsive: 12 against 11), and K3's pair work grows
    # with capacity squared. So the timed runs take a prologue at the
    # packing capacity and then repack the slab down to the run capacity:
    # a gather and a pack by current position, committed only if the pack
    # overflowed nothing.
    def repack_plan(self, nsteps: int):
        """``(min_steps, max_steps)`` of the repack attempts, or None: off
        before the first ``init_carry``, when the config or the law turns it
        off (``grid3_repack=None`` is on iff the law has no run-tail slot),
        when the run capacity is not below the packing capacity, or when
        the first attempt would come at or after the last step."""
        cfg = self.config
        if self._pack_capacity is None:
            return None
        enabled = cfg.grid3_repack
        if enabled is None:
            enabled = self._TAIL_SLOTS.get(cfg.force_law, 1) == 0
        if (not enabled or not self._repack_ok
                or self._repack_target() >= self._pack_capacity):
            return None
        K = self.rebin_every
        min_s = cfg.grid3_prologue_steps or self._REPACK_MIN_STEPS
        min_s = -(-min_s // K) * K  # attempts land on rebin steps
        if min_s >= nsteps:
            return None
        return min_s, max(min_s, min(nsteps // 2, self._REPACK_MAX_STEPS))

    def _repack_target(self) -> int:
        """The chooser's capacity for this config, raised to a capacity that
        a drop escalated to (a measured run demand: never repacked away)."""
        base = Geometry3S.for_config(self.config).capacity
        return max(base, self._escalated_floor)

    def attempt_repack(self, carry: GridCarry):
        """Repack ``carry`` from the current capacity to the run target.
        Returns ``(new_carry, overflow)``, overflow a host int (one wait for
        the device): 0 means ``new_carry`` is at the target capacity and the
        caller must :meth:`commit_repack`; > 0 means the pack by current
        position would have dropped particles, and ``new_carry`` is
        ``carry`` itself, untouched. The monitors carry over unchanged."""
        pos, vel = grid3d_ops.slab3_to_particles(carry.slab, self.geom,
                                                 self.config.num_parts)
        to_geom = dataclasses.replace(self.geom, capacity=self._repack_target())
        slab, overflow = grid3d_ops.slab3_from_particles(pos, vel, to_geom)
        overflow = int(overflow)
        if overflow:
            return carry, overflow
        return GridCarry(slab, carry.monitors), 0

    def commit_repack(self) -> None:
        """Flip the engine to the run capacity after a verified repack."""
        self._set_capacity(self._repack_target())

    # ---- drop-detected capacity escalation ---------------------------------
    def maybe_escalate_after_drop(self, result) -> bool:
        """An auto-capacity run that dropped particles raises capacity one
        slot and asks the caller to re-run from the initial state; a hand
        ``grid3_capacity`` never retries. The raised capacity becomes the
        floor of the repack target and of the packing capacity, so the
        re-run never repacks back down to the capacity that dropped."""
        dropped = int(result.monitors.migrate_dropped)
        if self.config.grid3_capacity is not None or dropped == 0:
            return False
        new_cap = self.geom.capacity + 1
        print(f"{self.name}: run dropped {dropped} particle(s) at capacity "
              f"{self.geom.capacity}; escalating to {new_cap} and re-running "
              "from the initial state", file=sys.stderr)
        self._escalated_floor = new_cap
        if self._pack_capacity is not None:
            self._pack_capacity = max(self._pack_capacity, new_cap)
        self._set_capacity(new_cap)
        return True

    # ---- protocol ----------------------------------------------------------
    def frame_of(self, carry: GridCarry) -> torch.Tensor:
        return grid3d_ops.slab3_positions(carry.slab, self.geom,
                                          self.config.num_parts)

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid3d_ops.slab3_to_particles(carry.slab, self.geom,
                                                 self.config.num_parts)
        return ParticleState(pos, vel)


@register_engine
class Cuda3DEngine(Grid3DEngine):
    """The 3D slab-grid engine on the Hopper kernels (the JAX package's
    ``pallas3d``): ``move_phase`` runs K3, ``rebin_of`` runs K4 then K5."""

    name = "cuda3d"

    def move_phase(self, slab: Slab3State):
        from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda

        cfg = self.config
        *planes, speed2 = grid3_step_cuda(
            *slab[:6], self.geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt,
            cfg.size, law=cfg.force_law, law_params=cfg.law_params)
        # dead slots hold v = 0, so the plane's max is the slabs' max
        return Slab3State(*planes, slab.pid), torch.sqrt(speed2.max())

    def rebin_of(self, slab: Slab3State):
        from ppsim_tpu_torch.ops.cuda_rebin3 import grid3_rebin_cuda

        return grid3_rebin_cuda(slab, self.geom, self.config.evac_capacity)
