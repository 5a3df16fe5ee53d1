"""O(N^2) all-pairs oracle engine, the in-repo ground truth (port of
:mod:`ppsim_tpu.engines.oracle`).

Every particle accumulates the force of every other particle (self-pairs
contribute exactly zero by the radial force law), then integrates: the
reference's brute-force engine (part1/reference.cpp:52-65). The pair matrix
is materialized in row blocks, so the live pair tensor is (block, N); a
Python loop over the blocks replaces the JAX package's ``lax.map``.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch.engines.base import Carry, Engine, register_engine
from ppsim_tpu_torch.physics import accel_fn_for, accel_vec_fn_for, verlet_step
from ppsim_tpu_torch.state import ParticleState

__all__ = ["OracleEngine", "all_pairs_accel", "all_pairs_accel_vec"]


def all_pairs_accel(pos, pair_fn, block: int = 2048):
    """(N, 2) accelerations from the dense all-pairs interaction;
    ``pair_fn(dx, dy) -> (ax, ay)`` is the force law
    (``physics.accel_fn_for``), each row's terms summed over all N."""
    out = []
    for i in range(0, pos.shape[0], block):
        prow = pos[i:i + block]
        ax, ay = pair_fn(pos[None, :, 0] - prow[:, 0:1], pos[None, :, 1] - prow[:, 1:2])
        out.append(torch.stack([ax.sum(dim=-1), ay.sum(dim=-1)], dim=-1))
    return torch.cat(out)


def all_pairs_accel_vec(pos, accel_vec, block: int = 2048):
    """Dimension-agnostic all-pairs accelerations: ``accel_vec`` is the
    (..., D)-displacement force law of ``physics.accel_vec_fn_for`` (the 3D
    oracle; the 2D path keeps the (dx, dy) form, which pairs bitwise with
    the binned engine)."""
    out = []
    for i in range(0, pos.shape[0], block):
        prow = pos[i:i + block]
        out.append(accel_vec(pos[None, :, :] - prow[:, None, :]).sum(dim=1))
    return torch.cat(out)


@register_engine
class OracleEngine(Engine):
    name = "oracle"
    supported_ndim = (2, 3)

    # profiling.phase_times' variant seam: "force" zeroes the accelerations
    # (the integrator still runs on zeros, so its cost stays in the
    # variant); "force+move" also skips the integrator.
    _phase_disable = None

    def step_carry(self, carry: Carry) -> Carry:
        cfg = self.config
        off = self._phase_disable
        if off in ("force", "force+move"):
            accel = torch.zeros_like(carry.pos)
        elif cfg.ndim == 2:
            accel = all_pairs_accel(carry.pos, accel_fn_for(cfg))
        else:
            accel = all_pairs_accel_vec(carry.pos, accel_vec_fn_for(cfg))
        if off == "force+move":
            pos, vel = carry.pos, carry.vel
        else:
            pos, vel = verlet_step(carry.pos, carry.vel, accel, cfg.dt, cfg.size)
        return Carry(pos, vel, carry.pid, carry.monitors)

    # The oracle never permutes particles: no id scatter.
    def frame_of(self, carry: Carry) -> torch.Tensor:
        return carry.pos

    def final_state(self, carry: Carry) -> ParticleState:
        return ParticleState(carry.pos, carry.vel)
