"""Particle state as a structure-of-arrays ``NamedTuple`` of tensors.

Port of :mod:`ppsim_tpu.state`: one ``(N, ndim)`` tensor per quantity
(the reference's array-of-structs ``particle_t``, part1/common.h:14-21, laid
out as structure-of-arrays). Accelerations are per-step temporaries and are
not carried (the reference zeroes them every force phase,
part1/serial.cpp:105).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ParticleState", "make_state"]


class ParticleState(NamedTuple):
    pos: torch.Tensor  # (N, ndim) positions
    vel: torch.Tensor  # (N, ndim) velocities

    @property
    def num_parts(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device=None, dtype=None) -> "ParticleState":
        return ParticleState(self.pos.to(device=device, dtype=dtype),
                             self.vel.to(device=device, dtype=dtype))

    def to_numpy(self):
        return self.pos.cpu().numpy(), self.vel.cpu().numpy()


def make_state(pos, vel, dtype=None, device=None) -> ParticleState:
    """Build a state from arrays or tensors (array input is copied)."""
    pos = pos if torch.is_tensor(pos) else torch.from_numpy(np.array(pos))
    vel = vel if torch.is_tensor(vel) else torch.from_numpy(np.array(vel))
    pos = pos.to(device=device, dtype=dtype)
    vel = vel.to(device=device, dtype=dtype)
    if pos.shape != vel.shape or pos.ndim != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(
            f"expected (N, 2) or (N, 3) pos/vel, got {tuple(pos.shape)} / "
            f"{tuple(vel.shape)}"
        )
    return ParticleState(pos, vel)
