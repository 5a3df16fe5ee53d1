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
table), one neighbour offset at a time. The list keeps only the occupied
cells (their sorted ids and where their particles start), and a neighbour
cell is found by a binary search over those ids, so that its memory grows
with the particles and not with the box's cells (in 3D at the benchmark's
density there are about 7 cells a particle). The live tensors stay a few
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


#: Particles, or occupied cells, worked out at once (bounds the temporaries of
#: the cell list to a few times this, whatever the particle count).
ROW_BLOCK = 1 << 24


def _flat_cells(pos, phys: Physics):
    """Per particle the flat id of its cell (the first axis fastest), and
    the cells per side."""
    n, ndim = pos.shape
    nc = max(1, int(math.floor(phys.size / phys.cutoff)))
    side = phys.size / nc
    stride = torch.tensor([nc ** k for k in range(ndim)], device=pos.device)
    flat = torch.empty(n, dtype=torch.long, device=pos.device)
    for lo in range(0, n, ROW_BLOCK):
        p = pos[lo:lo + ROW_BLOCK].to(torch.float64)
        cell = torch.clamp(torch.floor(p / side).long(), 0, nc - 1)
        flat[lo:lo + ROW_BLOCK] = (cell * stride).sum(1)
    return flat, nc


def _edges(uniq, nc: int, ndim: int):
    """Per occupied cell, bit ``2k`` set where it lies on the box's low face
    of axis ``k``, bit ``2k + 1`` on its high face."""
    edge = torch.zeros(len(uniq), dtype=torch.uint8, device=uniq.device)
    for k in range(ndim):
        c = torch.div(uniq, nc ** k, rounding_mode="floor") % nc
        edge |= (c == 0).to(torch.uint8) << (2 * k)
        edge |= (c == nc - 1).to(torch.uint8) << (2 * k + 1)
    return edge


def _neighbour_cells(uniq, bounds, edge, nc: int, off):
    """For one neighbour offset ``off``: per occupied cell the count of its
    neighbour cell's particles (0 outside the box or where no particle
    sits) and where they start in the sorted order. ``uniq`` holds the
    occupied cells' sorted ids and ``bounds[u] .. bounds[u + 1]`` the
    sorted positions of cell ``uniq[u]``'s particles. The neighbours' ids
    are sorted too, so the binary searches walk the table in order."""
    shift = sum(o * nc ** k for k, o in enumerate(off))
    leaves = sum(1 << (2 * k + (o > 0)) for k, o in enumerate(off) if o)
    cnt = torch.empty_like(uniq)
    start = torch.empty_like(uniq)
    last = len(uniq) - 1
    for lo in range(0, len(uniq), ROW_BLOCK):
        q = uniq[lo:lo + ROW_BLOCK] + shift
        u = torch.searchsorted(uniq, q).clamp_(max=last)
        found = (uniq[u] == q) & ((edge[lo:lo + ROW_BLOCK] & leaves) == 0)
        s = bounds[u]
        cnt[lo:lo + ROW_BLOCK] = torch.where(found, bounds[u + 1] - s, 0)
        start[lo:lo + ROW_BLOCK] = s
    return cnt, start


def _pairs(pos, phys: Physics):
    """Yield ``(i, j)`` index tensors of candidate ordered pairs, ``i != j``,
    both indices into ``pos``, one neighbour offset and at most
    :data:`MAX_PAIRS` candidates at a time. Every pair closer than the
    cutoff appears exactly once."""
    n, ndim = pos.shape
    dev = pos.device
    flat, nc = _flat_cells(pos, phys)
    order = torch.argsort(flat)
    uniq, inv, counts = torch.unique_consecutive(flat[order], return_inverse=True,
                                                 return_counts=True)
    del flat
    own = torch.empty_like(inv)  # per particle the index of its cell in uniq
    own[order] = inv
    del inv
    bounds = torch.zeros(len(uniq) + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=bounds[1:])
    del counts
    edge = _edges(uniq, nc, ndim)
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        ccnt, cstart = _neighbour_cells(uniq, bounds, edge, nc, off)
        ends = ccnt[own].cumsum_(0)
        lo = 0
        while lo < n:
            # rows lo .. hi - 1: at most MAX_PAIRS candidates, or one row
            base = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(ends, base + MAX_PAIRS, right=True)))
            c = ccnt[own[lo:hi]]
            size = int(ends[hi - 1]) - base
            if size:
                i = torch.repeat_interleave(torch.arange(lo, hi, device=dev), c,
                                            output_size=size)
                k = torch.arange(size, device=dev) - (torch.cumsum(c, 0) - c)[i - lo]
                j = order[cstart[own[i]] + k]
                keep = j != i
                yield i[keep], j[keep]
            lo = hi
        del ccnt, cstart, ends


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
    """The wall mirror, in place of ``x`` and ``v`` (the callers' own
    tensors): ``x -> size - |mod(x, 2 size) - size|``, ``v -> -v`` where
    ``mod(x, 2 size) > size``. Each operation rounds as its out-of-place
    form does, so the result is bitwise the same."""
    x.remainder_(2.0 * size)
    flip = x > size
    x.sub_(size).abs_().neg_().add_(size)
    v[flip] = v[flip].neg()
    return x, v


def forward_step(pos, vel, phys: Physics):
    """One step: force, ``v += a dt``, ``x += v dt``, wall mirror."""
    vel = accel(pos, phys).mul_(phys.dt).add_(vel)
    return _fold(torch.mul(vel, phys.dt).add_(pos), vel, phys.size)


def reverse_step(pos, vel, phys: Physics):
    """The state one step earlier than ``(pos, vel)`` (the inverse of
    :func:`forward_step` up to rounding)."""
    pos, vel = _fold(torch.mul(vel, phys.dt).neg_().add_(pos), vel.clone(), phys.size)
    return pos, accel(pos, phys).mul_(phys.dt).neg_().add_(vel)
