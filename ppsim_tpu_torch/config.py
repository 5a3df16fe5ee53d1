"""Simulation configuration (PyTorch port of :mod:`ppsim_tpu.config`).

Field for field the same frozen dataclass as the JAX package: the same
defaults, derived properties and ``validate()``, so that both packages derive
the same box size, bin size and slab geometry from one set of fields
(``convert.config_from_dict`` carries a JAX config across). The reference
hard-codes the physics constants (part1/common.h:4-11):

    nsteps=1000  savefreq=10  density=0.0005  mass=0.01
    cutoff=0.01  min_r=cutoff/100  dt=0.0005

Fields that only the JAX package's other engines read (the sort-binned,
sharded and 3D families) are kept so that a config round-trips unchanged;
the port's engines read the 2D slab-grid fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["SimConfig", "DEFAULTS"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen, hashable configuration for one simulation run."""

    # ---- physics constants (reference: part1/common.h:4-11) ----
    num_parts: int = 1000
    nsteps: int = 1000
    savefreq: int = 10
    density: float = 0.0005
    mass: float = 0.01
    cutoff: float = 0.01
    dt: float = 0.0005

    # ---- dimensionality (the reference is 2D-only; 3D is the stretch
    # config, box side (density * n)^(1/ndim)) ----
    ndim: int = 2

    # ---- force law: "repulsive" (the reference's) or "lj" (truncated
    # Lennard-Jones) ----
    force_law: str = "repulsive"
    lj_epsilon: float = 1.0e-4
    lj_sigma: float = 0.007

    # ---- numerics ----
    dtype: str = "float32"

    # ---- sort-binned engine tunables ----
    bin_scale: float = 2.0
    bin_capacity: int = 8
    shard_slack: float = 1.5
    migrate_capacity: Optional[int] = None

    # ---- dense slab-grid engine ----
    # Bin side in cutoffs; mean occupancy grid_bin_scale^2 cutoff^2/density.
    grid_bin_scale: float = 5.0
    # Slots per bin. None = AUTO: ops.grid_ops.GRID_CAPACITY_DEFAULT for the
    # scale-derived geometry (the lane snap derives its own) and the
    # drop-detected capacity escalation stays armed (engines/grid.py). An
    # explicit int is a hand override and disables the escalation.
    grid_capacity: Optional[int] = None
    grid3_bin_scale: float = 3.0
    grid3_capacity: Optional[int] = None
    grid3_spill: Optional[bool] = None
    grid3_snap_lanes: bool = True
    grid3_vmax: float = 4.0
    rebin3_every: Optional[int] = None
    grid3_repack: Optional[bool] = None
    grid3_prologue_steps: Optional[int] = None
    # Rebin cadence in steps. Stale binning stays correct while
    # rebin_every * max|v| * dt <= (bin_side - cutoff) / 2 (monitored).
    rebin_every: int = 8
    # Max particles leaving one bin in one direction per rebin; excess
    # defers to the next rebin (monitored).
    evac_capacity: int = 4
    # 2D rebin algorithm: "axes" (default) = the axis-factorized rebin (rows
    # pass, then cols pass; kernel K2); "dirs9" = the 9-direction dense
    # shuffle (counts K7 + shuffle K8), kept as the ablation against it. Both
    # are loss-free under the same acceptance contract; their deferral
    # decisions differ.
    grid_rebin_mode: str = "axes"
    # Score lane-exact geometries (bin counts on multiples of 128) with the
    # JAX package's fitted cost model, so that both packages choose the
    # identical grid (SlabGeometry.for_config).
    grid_snap_lanes: bool = True
    # "sort" (stable argsort by bin) is the port's pack; "claim" exists only
    # in the JAX package.
    grid_pack_mode: str = "sort"

    # ---- derived geometry ----
    @property
    def size(self) -> float:
        """Box side length (reference: part1/main.cpp:113 for 2D)."""
        if self.ndim == 2:
            # math.sqrt matches the C++ sqrt of the native code bit for bit.
            return math.sqrt(self.density * self.num_parts)
        return (self.density * self.num_parts) ** (1.0 / self.ndim)

    @property
    def min_r(self) -> float:
        """Minimum interaction distance (reference: part1/common.h:10)."""
        return self.cutoff / 100.0

    @property
    def bin_size(self) -> float:
        return self.bin_scale * self.cutoff

    @property
    def bins_per_side(self) -> int:
        return max(1, math.ceil(self.size / self.bin_size))

    @property
    def num_bins(self) -> int:
        return self.bins_per_side * self.bins_per_side

    @property
    def grid_bin_size(self) -> float:
        return self.grid_bin_scale * self.cutoff

    @property
    def grid_bins_per_side(self) -> int:
        return max(1, math.ceil(self.size / self.grid_bin_size))

    @property
    def grid_slack(self) -> float:
        """Max tolerated position drift between rebins (stale-bin safety)."""
        return (self.grid_bin_size - self.cutoff) / 2.0

    @property
    def grid3_bin_size(self) -> float:
        return self.grid3_bin_scale * self.cutoff

    @property
    def grid3_bins_per_side(self) -> int:
        return max(1, math.ceil(self.size / self.grid3_bin_size))

    @property
    def law_params(self) -> tuple:
        if self.force_law == "lj":
            return (self.lj_epsilon, self.lj_sigma)
        return ()

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r} "
                             "(float32 | float64)")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.bin_scale < 1.0:
            raise ValueError(
                f"bin_scale={self.bin_scale} < 1: the 3x3 stencil would miss "
                "in-range pairs (bin side must be >= cutoff)."
            )
        if self.num_parts <= 0:
            raise ValueError("num_parts must be positive")
        if self.bin_capacity < 1:
            raise ValueError("bin_capacity must be >= 1")
        if self.grid_bin_scale <= 1.0:
            raise ValueError(
                f"grid_bin_scale={self.grid_bin_scale} must exceed 1: the grid "
                "engine needs positive stale-bin slack (bin side > cutoff)."
            )
        if self.rebin_every < 1 or self.evac_capacity < 1:
            raise ValueError("rebin_every / evac_capacity must be >= 1")
        if self.grid_capacity is not None and self.grid_capacity < 1:
            raise ValueError("grid_capacity must be >= 1 (or None for auto)")
        if self.grid_pack_mode not in ("sort", "claim"):
            raise ValueError(
                f"grid_pack_mode={self.grid_pack_mode!r}: must be 'sort' or "
                f"'claim'")
        if self.grid_rebin_mode not in ("dirs9", "axes"):
            raise ValueError(
                f"grid_rebin_mode={self.grid_rebin_mode!r}: must be 'dirs9' or 'axes'"
            )
        if self.grid3_bin_scale <= 1.0:
            raise ValueError(
                f"grid3_bin_scale={self.grid3_bin_scale} must exceed 1: the 3D "
                "grid engines need positive stale-bin slack (bin side > cutoff)."
            )
        if self.rebin3_every is not None and self.rebin3_every < 1:
            raise ValueError("rebin3_every must be >= 1 (or None for auto)")
        if self.grid3_capacity is not None and self.grid3_capacity < 1:
            raise ValueError("grid3_capacity must be >= 1 (or None for auto)")
        if self.grid3_prologue_steps is not None and self.grid3_prologue_steps < 1:
            raise ValueError(
                "grid3_prologue_steps must be >= 1 (or None for auto)")
        if self.force_law not in ("repulsive", "lj"):
            raise ValueError(
                f"unknown force_law {self.force_law!r}; have 'repulsive', 'lj'"
            )
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")


DEFAULTS = SimConfig()
