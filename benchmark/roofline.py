"""The card's datasheet peaks, and the work one step needs, counted from
the problem.

The work is that of the physics, never of a layout: any implementation of
the same step is held to the same count.

- Bytes: each particle's position and velocity, read once and written once
  (``2 * 2 * ndim * itemsize`` a particle: 16 * ndim in float32).
- Flops: the unordered pairs closer than the cutoff times the flops of one
  pair, plus the move of each particle. The pairs are the mean count of a
  uniform gas of the configuration's density: ``n * V(cutoff) / density /
  2``, ``V`` the disc or ball of radius ``cutoff``.
- One pair (its force computed once and added to both particles): the
  difference (ndim), the squared distance (2 ndim - 1), the clamp (1),
  the law's coefficient, ``/ r2`` and ``/ mass`` (2), ``coef * d``
  (ndim) and the two updates (2 ndim). The repulsive coefficient ``1 -
  cutoff / r`` takes 3 (sqrt, divide, subtract); the Lennard-Jones one,
  ``-24 eps (2 s12 - s6)`` with ``s2 = sigma^2 / r2``, takes 7. So 2D
  repulsive 17, 2D Lennard-Jones 21, 3D repulsive 23, 3D Lennard-Jones 27.
- The move: ``v += a dt`` and ``x += v dt`` (4 a coordinate) and the wall
  test and fold (2 a coordinate): 6 * ndim a particle.

The least time of a step is the larger of its bytes at the memory peak and
its flops at the float32 peak.
"""

from __future__ import annotations

import math

__all__ = ["PEAKS", "peaks_of", "step_bytes", "mean_pairs", "step_flops",
           "least_step_s"]

#: Published dense peaks, SXM part at its 700 W limit (NVIDIA H100 Tensor
#: Core GPU datasheet): HBM3 3.35 TB/s, float32 off the tensor cores 67
#: TFLOP/s. Keyed by ``torch.cuda.get_device_name()``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}

#: Flops of one unordered pair within the cutoff, by (ndim, law).
PAIR_FLOPS = {(2, "repulsive"): 17, (2, "lj"): 21,
              (3, "repulsive"): 23, (3, "lj"): 27}


def peaks_of(device_name: str):
    """The datasheet peaks of a card, or None for a card not in the table."""
    return PEAKS.get(device_name)


def step_bytes(n: int, ndim: int, itemsize: int = 4) -> int:
    return 2 * 2 * ndim * itemsize * n


def mean_pairs(n: int, ndim: int, density: float, cutoff: float) -> float:
    """Unordered pairs closer than ``cutoff`` in a uniform gas of ``n``
    particles, ``density`` the volume a particle has."""
    ball = math.pi * cutoff ** 2 if ndim == 2 else 4.0 / 3.0 * math.pi * cutoff ** 3
    return n * ball / density / 2.0


def step_flops(n: int, ndim: int, density: float, cutoff: float,
               law: str) -> float:
    return (mean_pairs(n, ndim, density, cutoff) * PAIR_FLOPS[(ndim, law)]
            + 6 * ndim * n)


def least_step_s(n: int, ndim: int, density: float, cutoff: float, law: str,
                 peaks: dict):
    """``(seconds, bound)``: the least time of one step and whether
    ``"bytes"`` or ``"flops"`` sets it."""
    tb = step_bytes(n, ndim) / peaks["bytes_per_s"]
    tf = step_flops(n, ndim, density, cutoff, law) / peaks["flops_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "flops")
