"""Interchangeable simulation engines behind one protocol (port of
:mod:`ppsim_tpu.engines`):

- ``oracle`` — O(N^2) all-pairs ground truth, 2D and 3D;
- ``binned`` — sort-rebinned particle list with the 3x3 stencil gather (the
  JAX CLI's default engine); bitwise partner of the oracle;
- ``sharded`` — the particle list split into row strips over a shard mesh
  (``engines/mesh.py``), with ghost grid rows and emigrant buffers (the
  reference's MPI engine);
- ``grid`` — dense slab-grid engine in plain PyTorch, any device;
- ``cuda`` — the same engine on the Hopper kernels (the JAX package's
  ``pallas`` engine);
- ``sharded_grid`` — the 2D slab-grid engine split into row strips over the
  shard mesh (in one process, or one process a shard over
  ``torch.distributed``), on the kernels' shard forms;
- ``sharded_tile`` — the 2D slab-grid engine cut into tiles along both bin
  axes over a 2-D mesh, on the tile forms of K1 and K2;
- ``binned3d`` — the 3D particle list with the 3x3x3 stencil;
- ``grid3d`` / ``cuda3d`` — the 3D slab-grid engine, plain and on the Hopper
  kernels (the JAX package's ``grid3d`` / ``pallas3d``);
- ``sharded_grid3d`` — the 3D slab-grid engine split into y strips over the
  same mesh, on the shard forms of the 3D kernels.
"""

from ppsim_tpu_torch.engines.base import (
    Engine, RunResult, engine_names, get_engine, register_engine,
)

# Import for registration, in the JAX registry's order.
from ppsim_tpu_torch.engines import oracle as _oracle  # noqa: F401
from ppsim_tpu_torch.engines import binned as _binned  # noqa: F401
from ppsim_tpu_torch.engines import sharded as _sharded  # noqa: F401
from ppsim_tpu_torch.engines import grid as _grid  # noqa: F401
from ppsim_tpu_torch.engines import sharded_grid as _sharded_grid  # noqa: F401
from ppsim_tpu_torch.engines import sharded_tile as _sharded_tile  # noqa: F401
from ppsim_tpu_torch.engines import binned3d as _binned3d  # noqa: F401
from ppsim_tpu_torch.engines import grid3d as _grid3d  # noqa: F401
from ppsim_tpu_torch.engines import sharded_grid3d as _sharded_grid3d  # noqa: F401

__all__ = ["Engine", "RunResult", "engine_names", "get_engine", "register_engine"]
