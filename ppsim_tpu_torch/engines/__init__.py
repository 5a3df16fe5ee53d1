"""Interchangeable simulation engines behind one protocol (port of
:mod:`ppsim_tpu.engines`, the slab-grid family):

- ``grid`` — dense slab-grid engine in plain PyTorch, any device;
- ``cuda`` — the same engine on the Hopper kernels (the JAX package's
  ``pallas`` engine).
"""

from ppsim_tpu_torch.engines.base import (
    Engine, RunResult, engine_names, get_engine, register_engine,
)
from ppsim_tpu_torch.engines import grid as _grid  # noqa: F401  (registration)

__all__ = ["Engine", "RunResult", "engine_names", "get_engine", "register_engine"]
