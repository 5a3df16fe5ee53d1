"""3x3 neighbour-bin stencil forces over the capacity-padded grid (port of
:mod:`ppsim_tpu.ops.forces`).

Each particle gathers the capacity-padded slots of its 9 neighbour bins and
accumulates the masked pair force; empty slots hold the ``BIG`` sentinel and
fail the cutoff test for free. The loop runs over the 9 offsets, so the live
temporary is (N, capacity), not (N, 9 * capacity). Per offset the pair terms
are summed over the slots (:func:`slot_sum`), then the offsets are added in
``STENCIL`` order, the JAX package's: ``binned`` equals ``oracle`` bitwise
wherever a particle has at most two neighbours in range.

One-way accumulation (no Newton's-third-law halving), as the reference.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch.physics import accel_from_deltas

__all__ = ["STENCIL", "slot_sum", "stencil_accel"]

STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def slot_sum(t):
    """Sum of (N, k, ...) ``t`` over its k slots (dim 1) as a fixed pairwise
    tree (first half plus second half, an odd last slot carried to the next
    level): the same order on every device and for any N, where the order
    of ``torch.sum`` follows the reduction kernel the shape gets. The
    sharded engine's strips then sum a bin as the single-device engine does."""
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        head = t[:, :h] + t[:, h:2 * h]
        t = torch.cat([head, t[:, 2 * h:]], dim=1) if t.shape[1] % 2 else head
    return t[:, 0]


def stencil_accel(pos, row, col, slot_pos, geom, cutoff: float, min_r: float,
                  mass: float, pair_fn=None):
    """Accelerations on query particles from all particles in the 3x3 stencil.

    ``pos``: (N, 2) query positions; ``row`` / ``col``: (N,) their bin
    coordinates in ``geom`` (the sharded engine's include the ghost-row
    offset); ``slot_pos``: the grid's ((num_bins + 1) * cap, 2) slots.
    Out-of-grid neighbours are redirected to the void bin. ``pair_fn(dx, dy)
    -> (ax, ay)`` is the force law (default: the repulsive law). Returns
    (N, 2) accelerations.
    """
    if pair_fn is None:
        def pair_fn(dx, dy):
            return accel_from_deltas(dx, dy, cutoff, min_r, mass)
    cap = geom.capacity
    # the slots of a neighbour bin as an (N, cap) index: on CUDA gathering
    # its 8-byte rows is several times faster than gathering each query's
    # (cap, 2) block as one row
    cap_iota = torch.arange(cap, device=pos.device)[None, :]
    x = pos[:, 0:1]
    y = pos[:, 1:2]
    ax = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    ay = torch.zeros_like(ax)
    for dr, dc in STENCIL:
        nr = row + dr
        nc = col + dc
        valid = (nr >= 0) & (nr < geom.nrows) & (nc >= 0) & (nc < geom.ncols)
        nb = torch.where(valid, nr * geom.ncols + nc, geom.num_bins)
        npos = slot_pos[nb[:, None] * cap + cap_iota]  # (N, cap, 2) gather
        dax, day = pair_fn(npos[..., 0] - x, npos[..., 1] - y)
        ax = ax + slot_sum(dax)
        ay = ay + slot_sum(day)
    return torch.stack([ax, ay], dim=-1)
