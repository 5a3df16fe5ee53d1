"""The plain reference of the simulated physics, in PyTorch.

What the reference code does each step (part1/serial.cpp:19-61), in one
dtype chosen by the caller (float64 for the comparison; a lower one for the
control):

- every ordered pair ``(i, j)`` closer than ``cutoff`` adds ``coef(r2) * d``
  to the acceleration of ``i``, ``d = x_j - x_i``, ``r2 = max(|d|^2,
  min_r^2)``; ``coef = (1 - cutoff / r) / r2 / mass`` for the repulsive law
  and ``-24 eps (2 (s/r)^12 - (s/r)^6) / r2 / mass`` for the truncated
  Lennard-Jones law;
- ``v += a dt; x += v dt``;
- walls mirror: ``x -> L - |mod(x, 2L) - L|``, ``v -> -v`` where
  ``mod(x, 2L) > L``.

Pairs are found through a cell list of side at least ``cutoff``: the
particles are sorted by cell and each one meets the particles of its
3^ndim neighbour cells, every candidate pair enumerated exactly (no padded
table), one neighbour offset at a time so that the live tensors stay a few
times the particle count.

The step is reversible: with ``y = x' - v' dt`` folded by the same mirror
(which also flips ``v'`` where it folds), ``v = v' - a(y) dt`` restores the
state before the step up to rounding. :func:`reverse_step` does that, so
the comparison can follow the program back from its own final state.

Nothing here imports the program: it sees the physics only through
:class:`Physics`, built from a configuration file.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch

__all__ = ["Physics", "accel", "forward_step", "reverse_step", "MAX_PAIRS"]

#: Candidate pairs held at once (a lower precision can put thousands of
#: particles on one point, and so in one cell).
MAX_PAIRS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Physics:
    """The constants of one configuration: box side ``size``."""

    ndim: int
    size: float
    cutoff: float
    min_r: float
    mass: float
    dt: float
    law: str
    epsilon: float = 0.0
    sigma: float = 0.0

    @classmethod
    def of(cls, sim: dict) -> "Physics":
        """From a configuration's ``sim`` block (the box side is
        ``(density * n) ** (1 / ndim)``, ``sqrt`` in 2D as the reference)."""
        n, ndim = sim["num_parts"], sim["ndim"]
        size = (math.sqrt(sim["density"] * n) if ndim == 2
                else (sim["density"] * n) ** (1.0 / ndim))
        law = sim.get("force_law", "repulsive")
        if law not in ("repulsive", "lj"):
            raise ValueError(f"unknown force law {law!r}")
        return cls(ndim=ndim, size=size, cutoff=sim["cutoff"],
                   min_r=sim["cutoff"] / 100.0, mass=sim["mass"], dt=sim["dt"],
                   law=law, epsilon=sim.get("lj_epsilon", 0.0),
                   sigma=sim.get("lj_sigma", 0.0))


def _cells(pos, phys: Physics):
    """Per particle its integer cell ``(n, ndim)``, and the cells per side."""
    nc = max(1, int(math.floor(phys.size / phys.cutoff)))
    side = phys.size / nc
    cell = torch.clamp(torch.floor(pos.to(torch.float64) / side).long(), 0, nc - 1)
    return cell, nc


def _pairs(pos, phys: Physics):
    """Yield ``(i, j)`` index tensors of candidate ordered pairs, ``i != j``,
    both indices into ``pos``, one neighbour offset and at most
    :data:`MAX_PAIRS` candidates at a time. Every pair closer than the
    cutoff appears exactly once."""
    n, ndim = pos.shape
    dev = pos.device
    cell, nc = _cells(pos, phys)
    stride = torch.tensor([nc ** k for k in range(ndim)], device=dev)
    flat = (cell * stride).sum(1)
    order = torch.argsort(flat)
    counts = torch.bincount(flat, minlength=nc ** ndim)
    starts = torch.cumsum(counts, 0) - counts
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        nb = cell + torch.tensor(off, device=dev)
        inside = ((nb >= 0) & (nb < nc)).all(1)
        nflat = torch.where(inside, (nb.clamp(0, nc - 1) * stride).sum(1), 0)
        cnt = torch.where(inside, counts[nflat], 0)
        ends = torch.cumsum(cnt, 0)
        lo = 0
        while lo < n:
            # rows lo .. hi - 1: at most MAX_PAIRS candidates, or one row
            base = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(ends, base + MAX_PAIRS, right=True)))
            c = cnt[lo:hi]
            size = int(ends[hi - 1]) - base
            if size:
                i = torch.repeat_interleave(torch.arange(lo, hi, device=dev), c,
                                            output_size=size)
                k = torch.arange(size, device=dev) - (torch.cumsum(c, 0) - c)[i - lo]
                j = order[starts[nflat[i]] + k]
                keep = j != i
                yield i[keep], j[keep]
            lo = hi


def _coef(r2, phys: Physics):
    r2c = torch.clamp(r2, min=phys.min_r * phys.min_r)
    if phys.law == "repulsive":
        coef = (1.0 - phys.cutoff / torch.sqrt(r2c)) / r2c / phys.mass
    else:
        s2 = (phys.sigma * phys.sigma) / r2c
        s6 = s2 * s2 * s2
        coef = -24.0 * phys.epsilon * (2.0 * s6 * s6 - s6) / r2c / phys.mass
    return torch.where(r2 <= phys.cutoff * phys.cutoff, coef, torch.zeros_like(coef))


def accel(pos, phys: Physics):
    """``(n, ndim)`` accelerations of positions ``pos``, in ``pos``'s dtype."""
    acc = torch.zeros_like(pos)
    for i, j in _pairs(pos, phys):
        d = pos[j] - pos[i]
        coef = _coef((d * d).sum(1), phys)
        acc.index_add_(0, i, coef[:, None] * d)
    return acc


def _fold(x, v, size: float):
    m = torch.remainder(x, 2.0 * size)
    return size - torch.abs(m - size), torch.where(m > size, -v, v)


def forward_step(pos, vel, phys: Physics):
    """One step: force, ``v += a dt``, ``x += v dt``, wall mirror."""
    vel = vel + accel(pos, phys) * phys.dt
    return _fold(pos + vel * phys.dt, vel, phys.size)


def reverse_step(pos, vel, phys: Physics):
    """The state one step earlier than ``(pos, vel)`` (the inverse of
    :func:`forward_step` up to rounding)."""
    pos, vel = _fold(pos - vel * phys.dt, vel, phys.size)
    return pos, vel - accel(pos, phys) * phys.dt
