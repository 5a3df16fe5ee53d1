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
from ppsim_tpu_torch.ops.grid3d_ops import Slab3State
from ppsim_tpu_torch.ops.grid_ops import SlabState
from ppsim_tpu_torch.state import ParticleState, make_state

__all__ = ["config_from_dict", "particle_state_from_numpy", "slab_state_from_numpy",
           "slab3_state_from_numpy", "shards_from_numpy", "shards_to_numpy"]


def config_from_dict(fields: dict) -> SimConfig:
    """A SimConfig from a field dict; unknown fields raise."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return SimConfig(**fields)


def particle_state_from_numpy(pos, vel, device="cpu") -> ParticleState:
    """float32 ParticleState from (N, 2) or (N, 3) arrays."""
    return make_state(np.asarray(pos), np.asarray(vel), dtype=torch.float32,
                      device=device)


def slab_state_from_numpy(xl, yl, vx, vy, pid, device="cpu") -> SlabState:
    """SlabState from (cap, R, C) arrays: float32 fields, int32 pid."""
    f = lambda a, dt: torch.tensor(np.array(a, dt), device=device)  # noqa: E731
    return SlabState(*(f(a, np.float32) for a in (xl, yl, vx, vy)),
                     f(pid, np.int32))


def slab3_state_from_numpy(xl, yl, zl, vx, vy, vz, pid, device="cpu") -> Slab3State:
    """Slab3State from (cap, Y, X, Z) arrays (the JAX package's Slab3State
    as numpy): float32 fields, int32 pid."""
    f = lambda a, dt: torch.tensor(np.array(a, dt), device=device)  # noqa: E731
    return Slab3State(*(f(a, np.float32) for a in (xl, yl, zl, vx, vy, vz)),
                      f(pid, np.int32))


def shards_from_numpy(xl, yl, vx, vy, pid, shards: int, device="cpu"):
    """A JAX ``SlabState`` (as numpy, (cap, P * R, C)) cut into the port's
    list of ``shards`` row strips of R rows, each a SlabState of its own
    tensors (the sharded engine's carry)."""
    if np.shape(pid)[1] % shards:
        raise ValueError(f"{np.shape(pid)[1]} rows do not split into {shards} shards")
    parts = [np.split(np.asarray(a), shards, axis=1) for a in (xl, yl, vx, vy, pid)]
    return [slab_state_from_numpy(*fs, device=device) for fs in zip(*parts)]


def shards_to_numpy(shards):
    """The port's shard list back to the five (cap, P * R, C) numpy arrays
    (xl, yl, vx, vy, pid) of a JAX ``SlabState``."""
    return tuple(np.concatenate([s[k].cpu().numpy() for s in shards], axis=1)
                 for k in range(5))
