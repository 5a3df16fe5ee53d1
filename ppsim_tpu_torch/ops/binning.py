"""Sort-based rebinning into a capacity-padded bin grid (port of
:mod:`ppsim_tpu.ops.binning`).

The particle-list engines (``binned``, ``binned3d``, ``sharded``) rebuild a
dense ``(num_bins + 1, capacity)`` grid of positions every step:

1. ``bin_id = row * ncols + col`` per particle (row along x);
2. a stable sort by ``bin_id``, so particles land contiguous by bin;
3. rank within bin: index less the bin's first index (:func:`segment_ranks`);
4. a scatter of positions into the grid.

Bin ``num_bins`` is the *void bin*: every slot keeps the ``BIG`` sentinel,
so out-of-grid stencil neighbours are redirected there and fail the cutoff
test with no extra masking. Empty slots hold ``BIG`` too.

``sort_by_bin`` is a stable sort, so particles of one bin keep their
original index order and the within-bin ranks are the same as the JAX
package's (``jnp.argsort(stable=True)``): both packages put every particle
into the same (bin, slot).

JAX drops out-of-range scatter indices (``mode="drop"``); torch has no such
mode, and an out-of-range index is a device-side assert on CUDA. So every
index that JAX would drop goes to one sacrificial row past the end of the
buffer, which is sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ppsim_tpu_torch.physics import as_dtype

__all__ = ["BIG", "GridGeometry", "BinGrid", "bin_ids_of", "segment_ranks",
           "sort_by_bin", "build_grid"]

# Sentinel coordinate for empty slots; guarantees r2 >> cutoff^2.
BIG = 1.0e9


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static 2D bin-grid geometry of the particle-list engines."""

    nrows: int
    ncols: int
    capacity: int
    bin_size: float

    @property
    def num_bins(self) -> int:
        return self.nrows * self.ncols

    @property
    def num_slots(self) -> int:
        """Slot count including the trailing void bin."""
        return (self.num_bins + 1) * self.capacity

    @classmethod
    def square(cls, config) -> "GridGeometry":
        n = config.bins_per_side
        return cls(nrows=n, ncols=n, capacity=config.bin_capacity,
                   bin_size=config.bin_size)


class BinGrid(NamedTuple):
    """Dense capacity-padded grid of particle positions.

    ``slot_pos``: (num_slots, dim) positions, ``BIG`` where empty;
    ``slot_gid``: (num_slots,) int32 index of the occupying particle in the
    *sorted* order, -1 where empty; ``counts``: (num_bins,) int32 true
    occupancy (may exceed capacity); ``max_count``: 0-dim int32, the
    overflow monitor (> capacity: particles left out of the grid).
    """

    slot_pos: torch.Tensor
    slot_gid: torch.Tensor
    counts: torch.Tensor
    max_count: torch.Tensor


def bin_coord(x: torch.Tensor, inv: float, n: int) -> torch.Tensor:
    """``clip(int(x * inv), 0, n - 1)`` as int64: ``inv`` rounded to ``x``'s
    dtype as JAX rounds the weakly typed constant, the product truncated
    toward zero as ``astype(int32)`` does (through int64, so the ``BIG``
    sentinel of an empty slot converts without overflow)."""
    return torch.clamp((x * as_dtype(inv, x.dtype)).to(torch.int64), 0, n - 1)


def bin_ids_of(pos: torch.Tensor, geom: GridGeometry):
    """Per-particle (row, col, bin_id), int64. Row indexes x."""
    inv = 1.0 / geom.bin_size
    r = bin_coord(pos[..., 0], inv, geom.nrows)
    c = bin_coord(pos[..., 1], inv, geom.ncols)
    return r, c, r * geom.ncols + c


def segment_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal ids (ids must be
    sorted): its index less the index of its run's first element, found by
    binary search (the JAX package's running max of the run starts is a
    ``torch.cummax``, a slow scan on CUDA)."""
    idx = torch.arange(sorted_ids.shape[0], dtype=torch.int64, device=sorted_ids.device)
    return idx - torch.searchsorted(sorted_ids, sorted_ids)


def sort_by_bin(bin_id: torch.Tensor):
    """Stable sort permutation by bin id, plus rank-within-bin per sorted slot."""
    sorted_id, order = torch.sort(bin_id, stable=True)
    return order, sorted_id, segment_ranks(sorted_id)


def build_grid(pos_sorted: torch.Tensor, sorted_bin_id: torch.Tensor,
               rank: torch.Tensor, geom) -> BinGrid:
    """Scatter bin-sorted particles into the dense grid.

    ``pos_sorted`` must already be in bin order; ``rank`` is the within-bin
    slot index from :func:`sort_by_bin`. Particles ranked past ``capacity``,
    and particles of a bin past the void bin (the sharded engine's transit
    bin), stay out of the grid; ``counts`` covers the real bins only.
    ``geom`` needs ``capacity``, ``num_bins`` and ``num_slots`` (2D or 3D).
    """
    n, dim = pos_sorted.shape
    dev = pos_sorted.device
    cap, nb, num_slots = geom.capacity, geom.num_bins, geom.num_slots
    slot = sorted_bin_id * cap + rank
    slot = torch.where((rank < cap) & (slot < num_slots), slot, num_slots)

    slot_pos = torch.full((num_slots + 1, dim), BIG, dtype=pos_sorted.dtype, device=dev)
    slot_pos[slot] = pos_sorted
    slot_gid = torch.full((num_slots + 1,), -1, dtype=torch.int32, device=dev)
    slot_gid[slot] = torch.arange(n, dtype=torch.int32, device=dev)

    counts = torch.zeros(nb + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.clamp(sorted_bin_id, max=nb),
        torch.ones(n, dtype=torch.int32, device=dev))[:nb]
    return BinGrid(slot_pos[:num_slots], slot_gid[:num_slots], counts, counts.max())
