"""The seeded initial state of every simulation the benchmark runs.

A frozen copy of the lattice rule the reference's initializer follows
(part1/main.cpp:31-59: particles on a shuffled ceil(sqrt(N)) x sy lattice,
velocities uniform in [-1, 1)), extended to 3D as a shuffled
ceil(N^(1/3))^2 x sz lattice. The shuffle and the velocities come from one
``torch.Generator`` on the given device, in three large calls, so the same
seed gives the same float32 tensors on every run of a device. The
benchmark hands these tensors both to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

__all__ = ["lattice_state"]

_SEED_MASK = (1 << 64) - 1


def lattice_state(n: int, ndim: int, size: float, seed: int, device):
    """``(pos, vel)``, float32 ``(n, ndim)`` tensors on ``device``: lattice
    point ``k`` of a random permutation at ``size * (1 + i) / (1 + s)`` along
    each axis, ``i`` its index and ``s`` the points on that axis."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _SEED_MASK)
    k = torch.randperm(n, generator=gen, device=device)
    if ndim == 2:
        sx = int(math.ceil(math.sqrt(float(n))))
        axes = ((k % sx, sx), (k // sx, (n + sx - 1) // sx))
    elif ndim == 3:
        sx = int(math.ceil(float(n) ** (1.0 / 3.0)))
        axes = ((k % sx, sx), ((k // sx) % sx, sx),
                (k // (sx * sx), (n + sx * sx - 1) // (sx * sx)))
    else:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    pos = torch.stack([size * (1.0 + i.to(torch.float64)) / (1 + s)
                       for i, s in axes], dim=1).to(torch.float32)
    vel = torch.rand((n, ndim), generator=gen, device=device,
                     dtype=torch.float32) * 2.0 - 1.0
    return pos, vel
