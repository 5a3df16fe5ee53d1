"""Carry the JAX package's configs and states across as plain data, so that
both packages compute on identical inputs (the parity tests' bridge).

Nothing here imports the JAX package: a config arrives as the dict of its
fields (``dataclasses.asdict``) and states as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.ops.grid_ops import SlabState
from ppsim_tpu_torch.state import ParticleState, make_state

__all__ = ["config_from_dict", "particle_state_from_numpy", "slab_state_from_numpy"]


def config_from_dict(fields: dict) -> SimConfig:
    """A SimConfig from a field dict; unknown fields raise."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return SimConfig(**fields)


def particle_state_from_numpy(pos, vel, device="cpu") -> ParticleState:
    """float32 ParticleState from (N, 2) arrays."""
    return make_state(np.asarray(pos), np.asarray(vel), dtype=torch.float32,
                      device=device)


def slab_state_from_numpy(xl, yl, vx, vy, pid, device="cpu") -> SlabState:
    """SlabState from (cap, R, C) arrays: float32 fields, int32 pid."""
    f = lambda a, dt: torch.tensor(np.array(a, dt), device=device)  # noqa: E731
    return SlabState(*(f(a, np.float32) for a in (xl, yl, vx, vy)),
                     f(pid, np.int32))
