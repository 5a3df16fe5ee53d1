"""ppsim_tpu_torch — the PyTorch + Hopper (H100) port of :mod:`ppsim_tpu`.

A second package beside the JAX one, held against it piece by piece: module
names follow the JAX package, plain PyTorch replaces the XLA code, and each
Pallas kernel on the ported path becomes a CUDA C++ kernel for ``sm_90a``
(``csrc/``, built with nvcc at first use and bound with ctypes). The package
imports torch, numpy and ctypes, never jax or ppsim_tpu.

The port covers the whole JAX package, its TPU workarounds aside
(ROADMAP.md, "Do not port"):

- :mod:`ppsim_tpu_torch.config`, :mod:`~ppsim_tpu_torch.state`,
  :mod:`~ppsim_tpu_torch.physics`, :mod:`~ppsim_tpu_torch.initlib`,
  :mod:`~ppsim_tpu_torch.native`, :mod:`~ppsim_tpu_torch.io`,
  :mod:`~ppsim_tpu_torch.checker` — counterparts of the JAX modules;
- :mod:`ppsim_tpu_torch.ops.grid_ops`, :mod:`~ppsim_tpu_torch.ops.grid3d_ops`,
  :mod:`~ppsim_tpu_torch.ops.binning` and :mod:`~ppsim_tpu_torch.ops.forces`
  — the 2D and 3D slab grids and the particle-list bins in plain PyTorch;
- the kernel wrappers beside their plain twins, each kernel in ``csrc/``:
  :mod:`ppsim_tpu_torch.ops.cuda_grid` (K1 the fused 2D step, K6 the 2D
  force), :mod:`~ppsim_tpu_torch.ops.cuda_rebin` (K2 the axes rebin, K7 and
  K8 the dirs9 counts and shuffle), :mod:`~ppsim_tpu_torch.ops.cuda_grid3`
  (K3 the 3D step), :mod:`~ppsim_tpu_torch.ops.cuda_rebin3` (K4 and K5 the
  3D rebin), with their shard and tile forms, and
  :mod:`~ppsim_tpu_torch.ops.cuda_roofline` (the probes ``fma_chain`` and
  ``stream_add``);
- :mod:`ppsim_tpu_torch.engines` — the eleven engines of the JAX
  registry: ``grid``, ``grid3d`` (plain), ``cuda`` and ``cuda3d`` (the
  JAX ``pallas`` and ``pallas3d``), ``sharded_grid``, ``sharded_grid3d``
  and ``sharded_tile`` (shards in one process, ``LocalMesh``, or one a
  process under ``torchrun``, ``DistMesh``), and ``oracle``, ``binned``,
  ``binned3d`` and ``sharded``; ``Engine.run(..., max_device_frame_bytes)``
  keeps a saved run's frames on the device within its budget (2 GiB, the
  JAX default) and streams them to host memory past it
  (``engines.base.FrameSink``);
- :mod:`ppsim_tpu_torch.harness` — the CLI (``python -m ppsim_tpu_torch``),
  with the 3D capacity-phase repack, ``--resume`` and ``--checkpoint-out``;
- :mod:`ppsim_tpu_torch.roofline` — the port of ``bench/mfu.py``: the
  card's float32 FMA and stream rates and the step kernel's roofline
  (``python -m ppsim_tpu_torch.roofline``);
- :mod:`ppsim_tpu_torch.profiling` — a ``torch.profiler`` window over
  steps, the per-step phase split, a Chrome trace, the run path's
  ``ppsim.*`` spans (off unless ``profiling.tracing()``) and the engines'
  ``Counters``;
- :mod:`ppsim_tpu_torch.convert` and :mod:`~ppsim_tpu_torch.testing` —
  configs and states carried across as numpy, and the test slabs, for the
  parity tests.
"""

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "__version__"]
