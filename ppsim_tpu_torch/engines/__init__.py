"""Interchangeable simulation engines behind one protocol (port of
:mod:`ppsim_tpu.engines`, the slab-grid family):

- ``grid`` — dense slab-grid engine in plain PyTorch, any device;
- ``cuda`` — the same engine on the Hopper kernels (the JAX package's
  ``pallas`` engine);
- ``grid3d`` / ``cuda3d`` — the 3D slab-grid engine, plain and on the Hopper
  kernels (the JAX package's ``grid3d`` / ``pallas3d``);
- ``sharded_grid`` — the 2D slab-grid engine split into row strips over a
  shard mesh (``engines/mesh.py``: in one process, or one process a shard
  over ``torch.distributed``), on the kernels' shard forms;
- ``sharded_grid3d`` — the 3D slab-grid engine split into y strips over the
  same mesh, on the shard forms of the 3D kernels;
- ``sharded_tile`` — the 2D slab-grid engine cut into tiles along both bin
  axes over a 2-D mesh, on the tile forms of K1 and K2.
"""

from ppsim_tpu_torch.engines.base import (
    Engine, RunResult, engine_names, get_engine, register_engine,
)
from ppsim_tpu_torch.engines import grid as _grid  # noqa: F401  (registration)
from ppsim_tpu_torch.engines import grid3d as _grid3d  # noqa: F401  (registration)
from ppsim_tpu_torch.engines import sharded_grid as _sharded_grid  # noqa: F401  (registration)
from ppsim_tpu_torch.engines import sharded_grid3d as _sharded_grid3d  # noqa: F401  (registration)
from ppsim_tpu_torch.engines import sharded_tile as _sharded_tile  # noqa: F401  (registration)

__all__ = ["Engine", "RunResult", "engine_names", "get_engine", "register_engine"]
