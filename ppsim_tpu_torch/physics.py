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
    "const_like",
    "coef_from_r2",
    "lj_coef_from_r2",
    "accel_from_deltas",
    "lj_accel_from_deltas",
    "accel_fn_for",
    "accel_vec_fn_for",
    "pair_accel",
    "reflect_walls",
    "verlet_step",
]


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a Python float that the tensor dtype holds
    exactly, so tensor-scalar ops see the same constant as JAX)."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def const_like(x: float, t):
    """``x`` as a 0-dim tensor of ``t``'s dtype on ``t``'s device. Division
    by it, or of it, is a true elementwise division on every device, as in
    JAX: torch computes ``scalar / t`` as ``reciprocal(t) * scalar``, and on
    CUDA ``t / scalar`` as ``t * (1 / scalar)``, each an extra rounding."""
    return torch.full((), as_dtype(x, t.dtype), dtype=t.dtype, device=t.device)


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
    coef = (1.0 - const_like(cut, r) / r) / r2c / const_like(mass, r)
    return torch.where(in_range, coef, torch.zeros_like(coef))


def lj_coef_from_r2(r2, cutoff: float, min_r: float, mass: float,
                    epsilon: float, sigma: float):
    """Truncated Lennard-Jones coefficient:
    -24 eps (2 (sigma/r)^12 - (sigma/r)^6) / r^2 / mass inside ``cutoff``."""
    dt = r2.dtype
    cut = as_dtype(cutoff, dt)
    in_range = r2 <= cut * cut
    r2c = torch.clamp(r2, min=as_dtype(min_r * min_r, dt))
    s2 = const_like(sigma * sigma, r2c) / r2c
    s6 = s2 * s2 * s2
    coef = -24.0 * epsilon * (2.0 * s6 * s6 - s6) / r2c / const_like(mass, r2c)
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


def accel_vec_fn_for(config):
    """Dimension-agnostic pair-acceleration closure ``d -> a``: ``d`` the
    (..., ndim) displacement ``pos_neighbour - pos_self``, ``a`` the (...,
    ndim) acceleration contribution (the 3D engines' force-law seam). The
    squared distance is summed in axis order, x then y (then z), as the JAX
    package's reduction over the last axis adds them."""
    if config.force_law == "repulsive":
        coef_of = lambda r2: coef_from_r2(r2, config.cutoff, config.min_r,  # noqa: E731
                                          config.mass)
    elif config.force_law == "lj":
        coef_of = lambda r2: lj_coef_from_r2(  # noqa: E731
            r2, config.cutoff, config.min_r, config.mass,
            config.lj_epsilon, config.lj_sigma,
        )
    else:
        raise ValueError(f"unknown force_law {config.force_law!r}")

    def accel_vec(d):
        r2 = d[..., 0] * d[..., 0]
        for k in range(1, d.shape[-1]):
            r2 = r2 + d[..., k] * d[..., k]
        return coef_of(r2)[..., None] * d

    return accel_vec


def pair_accel(pos_i, pos_j, cutoff: float, min_r: float, mass: float):
    """Repulsive acceleration on particle(s) at ``pos_i`` from neighbour(s)
    at ``pos_j``: (..., 2) tensors broadcastable against each other."""
    d = pos_j - pos_i
    ax, ay = accel_from_deltas(d[..., 0], d[..., 1], cutoff, min_r, mass)
    return torch.stack([ax, ay], dim=-1)


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
