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
           "slab3_state_from_numpy", "shards_from_numpy", "shards3_from_numpy",
           "shards_to_numpy", "tiles_from_numpy", "tiles_to_numpy",
           "shard_carry_from_numpy", "shard_carry_to_numpy"]


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


def shards3_from_numpy(xl, yl, zl, vx, vy, vz, pid, shards: int, device="cpu"):
    """A JAX ``Slab3State`` (as numpy, (cap, P * Y, X, Z)) cut into the
    port's list of ``shards`` y strips of Y slabs, each a Slab3State of its
    own tensors (the 3D sharded engine's carry)."""
    if np.shape(pid)[1] % shards:
        raise ValueError(f"{np.shape(pid)[1]} y slabs do not split into {shards} shards")
    parts = [np.split(np.asarray(a), shards, axis=1)
             for a in (xl, yl, zl, vx, vy, vz, pid)]
    return [slab3_state_from_numpy(*fs, device=device) for fs in zip(*parts)]


def shards_to_numpy(shards):
    """The port's shard list back to the numpy arrays of a JAX slab state:
    the five (cap, P * R, C) arrays (xl, yl, vx, vy, pid) of a
    ``SlabState``, or the seven (cap, P * Y, X, Z) of a ``Slab3State``."""
    return tuple(np.concatenate([s[k].cpu().numpy() for s in shards], axis=1)
                 for k in range(len(shards[0])))


def tiles_from_numpy(xl, yl, vx, vy, pid, mesh_shape, device="cpu"):
    """A JAX ``SlabState`` (as numpy, (cap, Pr * R, Pc * C)) cut into the
    port's list of Pr x Pc tiles of R x C bins, row-major, each a SlabState
    of its own tensors (the tile engine's carry)."""
    pr, pc = mesh_shape
    _, rows, cols = np.shape(pid)
    if rows % pr or cols % pc:
        raise ValueError(f"{rows} x {cols} bins do not split into {pr} x {pc} tiles")
    parts = [[t for band in np.split(np.asarray(a), pr, axis=1)
              for t in np.split(band, pc, axis=2)] for a in (xl, yl, vx, vy, pid)]
    return [slab_state_from_numpy(*fs, device=device) for fs in zip(*parts)]


def tiles_to_numpy(tiles, mesh_shape):
    """The port's tile list (row-major on a (Pr, Pc) mesh) back to the five
    (cap, Pr * R, Pc * C) numpy arrays of a JAX ``SlabState``."""
    pc = mesh_shape[1]
    return tuple(np.concatenate([np.concatenate([t[k].cpu().numpy() for t in tiles[r:r + pc]],
                                                axis=2)
                                 for r in range(0, len(tiles), pc)], axis=1)
                 for k in range(len(tiles[0])))


def shard_carry_from_numpy(pos, vel, pid, shards: int, device="cpu"):
    """A JAX ``ShardCarry`` (the global view as numpy: (P * N_cap, 2) ``pos``
    and ``vel``, (P * N_cap,) ``pid`` with -1 for empty slots) cut into the
    port's per-shard ``ShardCarry`` of ``shards`` strips, on ``device``, with
    zero monitors and each slot of origin ``HERE`` (the JAX carry keeps no
    origin: a carry fresh from ``init_carry`` has none to keep)."""
    from ppsim_tpu_torch.engines.base import Monitors
    from ppsim_tpu_torch.engines.sharded import HERE, ShardCarry

    if np.shape(pid)[0] % shards:
        raise ValueError(f"{np.shape(pid)[0]} slots do not split into {shards} shards")
    f = lambda a, dt: [torch.tensor(np.array(b, dt), device=device)  # noqa: E731
                       for b in np.split(np.asarray(a), shards)]
    dt = np.asarray(pos).dtype
    pids = f(pid, np.int32)
    origin = [torch.full(p.shape, HERE, dtype=torch.int8, device=device) for p in pids]
    return ShardCarry(f(pos, dt), f(vel, dt), pids, origin, Monitors.zeros(device))


def shard_carry_to_numpy(carry):
    """The port's per-shard ``ShardCarry`` back to the numpy global view of
    a JAX ``ShardCarry``: (pos, vel, pid) concatenated over the shards (the
    origin tags have no JAX counterpart)."""
    return tuple(np.concatenate([t.cpu().numpy() for t in ts])
                 for ts in (carry.pos, carry.vel, carry.pid))
