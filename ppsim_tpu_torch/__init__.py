"""ppsim_tpu_torch — the PyTorch + Hopper (H100) port of :mod:`ppsim_tpu`.

A second package beside the JAX one, held against it piece by piece: module
names follow the JAX package, plain PyTorch replaces the XLA code, and each
Pallas kernel on the ported path becomes a CUDA C++ kernel for ``sm_90a``
(``csrc/``, built with nvcc at first use and bound with ctypes). The package
imports torch, numpy and ctypes, never jax or ppsim_tpu.

Ported slices: the 2D slab-grid main path (float32, sort-mode pack,
axis-factorized rebin; repulsive and LJ laws) and the 3D slab grid of the
stretch config (3D Lennard-Jones at n = 20M):

- :mod:`ppsim_tpu_torch.config`, :mod:`~ppsim_tpu_torch.state`,
  :mod:`~ppsim_tpu_torch.physics`, :mod:`~ppsim_tpu_torch.initlib`,
  :mod:`~ppsim_tpu_torch.native`, :mod:`~ppsim_tpu_torch.io`,
  :mod:`~ppsim_tpu_torch.checker` — counterparts of the JAX modules;
- :mod:`ppsim_tpu_torch.ops.grid_ops` and :mod:`~ppsim_tpu_torch.ops.grid3d_ops`
  — the 2D and 3D slab grids in plain PyTorch;
- :mod:`ppsim_tpu_torch.ops.cuda_grid` (K1, the fused step),
  :mod:`~ppsim_tpu_torch.ops.cuda_rebin` (K2, the rebin),
  :mod:`~ppsim_tpu_torch.ops.cuda_grid3` (K3, the 3D fused step) and
  :mod:`~ppsim_tpu_torch.ops.cuda_rebin3` (K4 and K5, the 3D rebin) — kernel
  wrappers beside their plain twins;
- :mod:`ppsim_tpu_torch.engines` — ``grid`` and ``grid3d`` (plain),
  ``cuda`` and ``cuda3d`` (kernels);
- :mod:`ppsim_tpu_torch.profiling` — a ``torch.profiler`` window over steps;
- :mod:`ppsim_tpu_torch.harness` — the CLI (``python -m ppsim_tpu_torch``);
- :mod:`ppsim_tpu_torch.convert` — carries JAX-package configs and states
  across as numpy, for the parity tests.
"""

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "__version__"]
