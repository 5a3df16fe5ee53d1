"""Sort-based binning helpers (port of the parts of :mod:`ppsim_tpu.ops.binning`
that the slab-grid pack uses).

``sort_by_bin`` is a stable sort, so particles of one bin keep their
original index order and the within-bin ranks are the same as the JAX
package's (``jnp.argsort(stable=True)``): both packages put every particle
into the same (bin, slot).
"""

from __future__ import annotations

import torch

__all__ = ["BIG", "segment_ranks", "sort_by_bin"]

# Sentinel coordinate for empty slots; guarantees r2 >> cutoff^2.
BIG = 1.0e9


def segment_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal ids (ids must be sorted)."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - seg_start


def sort_by_bin(bin_id: torch.Tensor):
    """Stable sort permutation by bin id, plus rank-within-bin per sorted slot."""
    sorted_id, order = torch.sort(bin_id, stable=True)
    return order, sorted_id, segment_ranks(sorted_id)
