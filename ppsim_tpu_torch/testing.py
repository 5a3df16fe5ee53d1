"""Test inputs shared by the CPU tests and ``chip_smoke.py`` (numpy, from a
seed, so that every device and both packages see identical data)."""

from __future__ import annotations

import numpy as np

from ppsim_tpu_torch.convert import slab_state_from_numpy
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry, SlabState

__all__ = ["STRESS_GEOMETRY", "stress_slab"]

# 13 x 100 physical bins padded to 16 x 128, capacity 4: the JAX package's
# contention geometry (tests/test_grid_ops.py).
STRESS_GEOMETRY = SlabGeometry(rows=13, cols=100, rows_pad=16, cols_pad=128,
                               capacity=4, bin_size=0.05)


def stress_slab(geom: SlabGeometry, seed: int = 0, far_movers: int = 0,
                device="cpu") -> SlabState:
    """Near-capacity random slab whose live particles sit up to one bin
    outside their own (directions in {-1, 0, 1}), plus ``far_movers``
    particles 2.2 bins out (stale-slack violations): heavy acceptance
    contention for the rebin. Same draws as the JAX package's
    ``tests/test_grid_ops._stress_slab``."""
    rng = np.random.default_rng(seed)
    cap, R, C = geom.shape
    occ = rng.integers(0, cap + 1, size=(R, C))
    occ[geom.rows:, :] = 0
    occ[:, geom.cols:] = 0
    xl = np.full((cap, R, C), BIG, np.float32)
    yl = np.full((cap, R, C), BIG, np.float32)
    vx = np.zeros((cap, R, C), np.float32)
    vy = np.zeros((cap, R, C), np.float32)
    pid = np.full((cap, R, C), -1, np.int32)
    k = 0
    bs = geom.bin_size
    for r in range(geom.rows):
        for c in range(geom.cols):
            for s in range(occ[r, c]):
                xl[s, r, c] = rng.uniform(-bs, 2 * bs)
                yl[s, r, c] = rng.uniform(-bs, 2 * bs)
                vx[s, r, c] = rng.normal()
                vy[s, r, c] = rng.normal()
                pid[s, r, c] = k
                k += 1
    for i in range(far_movers):
        r, c = 2 + i, 2
        if pid[0, r, c] < 0:
            pid[0, r, c] = k
            k += 1
        xl[0, r, c] = 2.2 * bs  # raw row direction 2
        yl[0, r, c] = 0.5 * bs
    return slab_state_from_numpy(xl, yl, vx, vy, pid, device=device)
