"""Pure physics functions on tensors (port of :mod:`ppsim_tpu.physics`).

Physics contract (reference: part1/serial.cpp:19-71):

- pair force: repulsive radial force within ``cutoff``; with
  ``r2 = max(dx^2+dy^2, min_r^2)``, ``coef = (1 - cutoff/r) / r2 / mass``,
  acceleration += ``coef * (dx, dy)``;
- integration: ``v += a*dt; x += v*dt`` (part1/serial.cpp:47-50);
- walls: the closed form of iterated mirroring, ``L - |mod(x, 2L) - L|``,
  velocity flipped on odd reflections (part1/serial.cpp:53-61).

Scalars enter the float32 arithmetic as float32 values (``float(np.float32(
x))``), the way JAX's weakly typed Python scalars do, so that both packages
round the same constants.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "coef_from_r2",
    "lj_coef_from_r2",
    "accel_from_deltas",
    "lj_accel_from_deltas",
    "accel_fn_for",
    "reflect_walls",
    "verlet_step",
]


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a Python float that the tensor dtype holds
    exactly, so tensor-scalar ops see the same constant as JAX)."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def coef_from_r2(r2, cutoff: float, min_r: float, mass: float):
    """Repulsive pair coefficient: the acceleration contribution is
    ``coef * d`` componentwise (reference: part1/serial.cpp:19-36)."""
    dt = r2.dtype
    cut = as_dtype(cutoff, dt)
    # cut*cut is exact in double; the compare rounds it once to the tensor
    # dtype, which is the float32 product JAX computes
    in_range = r2 <= cut * cut
    r2c = torch.clamp(r2, min=as_dtype(min_r * min_r, dt))
    r = torch.sqrt(r2c)
    coef = (1.0 - cut / r) / r2c / as_dtype(mass, dt)
    return torch.where(in_range, coef, torch.zeros_like(coef))


def lj_coef_from_r2(r2, cutoff: float, min_r: float, mass: float,
                    epsilon: float, sigma: float):
    """Truncated Lennard-Jones coefficient:
    -24 eps (2 (sigma/r)^12 - (sigma/r)^6) / r^2 / mass inside ``cutoff``."""
    dt = r2.dtype
    cut = as_dtype(cutoff, dt)
    in_range = r2 <= cut * cut
    r2c = torch.clamp(r2, min=as_dtype(min_r * min_r, dt))
    s2 = as_dtype(sigma * sigma, dt) / r2c
    s6 = s2 * s2 * s2
    coef = -24.0 * epsilon * (2.0 * s6 * s6 - s6) / r2c / mass
    return torch.where(in_range, coef, torch.zeros_like(coef))


def accel_from_deltas(dx, dy, cutoff: float, min_r: float, mass: float):
    """Acceleration on a particle from neighbours at offsets
    ``(dx, dy) = neighbour - self``; out-of-cutoff pairs give exactly 0."""
    coef = coef_from_r2(dx * dx + dy * dy, cutoff, min_r, mass)
    return coef * dx, coef * dy


def lj_accel_from_deltas(dx, dy, cutoff: float, min_r: float, mass: float,
                         epsilon: float, sigma: float):
    coef = lj_coef_from_r2(dx * dx + dy * dy, cutoff, min_r, mass, epsilon, sigma)
    return coef * dx, coef * dy


def accel_fn_for(config):
    """Pair-acceleration closure ``(dx, dy) -> (ax, ay)`` for a config (the
    engines' force-law seam)."""
    if config.force_law == "repulsive":
        return lambda dx, dy: accel_from_deltas(
            dx, dy, config.cutoff, config.min_r, config.mass
        )
    if config.force_law == "lj":
        return lambda dx, dy: lj_accel_from_deltas(
            dx, dy, config.cutoff, config.min_r, config.mass,
            config.lj_epsilon, config.lj_sigma,
        )
    raise ValueError(f"unknown force_law {config.force_law!r}")


def reflect_walls(pos, vel, size: float):
    """Reflect positions into [0, size], flipping velocities on odd
    reflections. ``torch.remainder`` is floored like ``jnp.mod``."""
    L = as_dtype(size, pos.dtype)
    m = torch.remainder(pos, 2.0 * L)
    folded = L - torch.abs(m - L)
    return folded, torch.where(m > L, -vel, vel)


def verlet_step(pos, vel, accel, dt: float, size: float):
    """One simplified-velocity-Verlet step with wall reflection
    (reference: ``move``, part1/serial.cpp:44-61)."""
    dtf = as_dtype(dt, pos.dtype)
    vel = vel + accel * dtf
    pos = pos + vel * dtf
    return reflect_walls(pos, vel, size)
