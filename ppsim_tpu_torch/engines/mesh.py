"""The shard transport of the sharded engines: a 1-D mesh of P row (2D) or
y-slab (3D) strips (the JAX package's ``shard_map`` over a ``Mesh(devices,
("x",))`` with ``lax.ppermute`` / ``psum`` / ``pmax``,
``engines/sharded_grid.py:114-124``).

Two implementations of one interface. An engine holds the shards of its
process (``mesh.shards``: their global indices, 0..P-1 in all) and calls
the mesh with one tensor per local shard:

- :meth:`from_above` / :meth:`from_below` — each shard receives its
  neighbour's tensor (from shard d-1 / d+1); the edge shard gets ``fill``;
- :meth:`halo` — both ghost blocks of a shard's planes: the last ``top_h``
  rows of the shard above and the first ``bot_h`` rows of the shard below
  (the strip axis is dim 1: (k, R, C) planes in 2D, (k, Y, X, Z) in 3D);
- :meth:`psum` / :meth:`pmax` — the sum / max over all shards, the same
  tensor in every process;
- :meth:`split` / :meth:`gather` — a global slab plane to the local shards
  (along dim 1) and back.

:class:`LocalMesh` holds all P shards in one process (the counterpart of
the JAX CLI's ``--cpu-mesh N``): each shard is a tensor of its own, and
every exchange copies into fresh buffers, as a receive would deliver them,
so a kernel can never read its neighbour's rows by accident.
:class:`DistMesh` runs over ``torch.distributed``, one shard a process:
point-to-point sends through ``batch_isend_irecv`` and ``all_reduce`` for
the reductions (gloo on the CPU, NCCL on cards).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ppsim_tpu_torch.engines.base import resolve_device

__all__ = ["LocalMesh", "DistMesh", "mesh_for", "field_halos"]


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in a buffer of its own."""
    return t.clone(memory_format=torch.contiguous_format)


class _Fills:
    """Edge-fill blocks, made once per shape, type, device and value (the
    kernels only read ghosts, so one block serves every step)."""

    def __init__(self):
        self._cache: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, like: torch.Tensor, fill) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype, like.device, fill)
        if key not in self._cache:
            self._cache[key] = torch.full_like(like, fill,
                                               memory_format=torch.contiguous_format)
        return self._cache[key]


class LocalMesh:
    """P shards in one process, on ``device``."""

    def __init__(self, size: int, device):
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        self.size = size
        self.device = torch.device(device)
        self.shards = range(size)
        self._fill = _Fills()

    def from_above(self, xs: Sequence[torch.Tensor], fill) -> List[torch.Tensor]:
        """Shard d gets shard d-1's tensor (a fresh copy); shard 0 ``fill``."""
        return [self._fill(xs[0], fill)] + [_fresh(x) for x in xs[:-1]]

    def from_below(self, xs: Sequence[torch.Tensor], fill) -> List[torch.Tensor]:
        """Shard d gets shard d+1's tensor (a fresh copy); shard P-1 ``fill``."""
        return [_fresh(x) for x in xs[1:]] + [self._fill(xs[-1], fill)]

    def halo(self, fs: Sequence[torch.Tensor], fill, top_h: int,
             bot_h: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(top, bot)`` ghost blocks of each shard's (k, R, ...) planes
        (strips along dim 1): ``top`` the last ``top_h`` rows of the shard
        above, ``bot`` the first ``bot_h`` rows of the shard below (``fill``
        at the edges)."""
        top = self.from_above([f[:, -top_h:] for f in fs], fill)
        bot = self.from_below([f[:, :bot_h] for f in fs], fill)
        return list(zip(top, bot))

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs)).sum(dim=0)

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs)).amax(dim=0)

    def split(self, f: torch.Tensor) -> List[torch.Tensor]:
        """The shards' rows of a (k, P * R, ...) plane, each in its own buffer."""
        return [_fresh(t) for t in f.chunk(self.size, dim=1)]

    def gather(self, fs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(fs), dim=1)


class DistMesh:
    """One shard a process, over the default ``torch.distributed`` process
    group (initialized by the caller, or by :meth:`from_env`). Its tensors
    live on ``device``: the CPU under gloo, the process's card under NCCL."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialized torch.distributed "
                               "process group")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.shards = (self.rank,)
        self._fill = _Fills()

    @classmethod
    def from_env(cls, device="cuda") -> "DistMesh":
        """The mesh of a ``torchrun`` launch (``WORLD_SIZE``, ``RANK``,
        ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment):
        initializes the process group if needed, NCCL on the card
        ``cuda:LOCAL_RANK`` or gloo on the CPU."""
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                                   "available (torch.cuda.is_available() is False)")
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method="env://")
        return cls(dev)

    def _exchange(self, up, down, fill):
        """Send ``down`` to rank+1 and ``up`` to rank-1 (either may be None:
        no send that way). Returns (above, below): what rank-1 sent down and
        what rank+1 sent up, each received into a fresh buffer, ``fill`` at
        the edges (None where nothing travels that way)."""
        r, P = self.rank, self.size
        above = below = None
        ops = []
        if down is not None:
            above = self._fill(down, fill)
            if r > 0:
                above = torch.empty_like(above)
                ops.append(dist.P2POp(dist.irecv, above, r - 1))
            if r < P - 1:
                ops.append(dist.P2POp(dist.isend, _fresh(down), r + 1))
        if up is not None:
            below = self._fill(up, fill)
            if r < P - 1:
                below = torch.empty_like(below)
                ops.append(dist.P2POp(dist.irecv, below, r + 1))
            if r > 0:
                ops.append(dist.P2POp(dist.isend, _fresh(up), r - 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return above, below

    def from_above(self, xs, fill):
        (x,) = xs
        return [self._exchange(None, x, fill)[0]]

    def from_below(self, xs, fill):
        (x,) = xs
        return [self._exchange(x, None, fill)[1]]

    def halo(self, fs, fill, top_h: int, bot_h: int):
        (f,) = fs
        return [self._exchange(f[:, :bot_h], f[:, -top_h:], fill)]

    def psum(self, xs):
        (x,) = xs
        y = _fresh(x)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def pmax(self, xs):
        (x,) = xs
        y = _fresh(x)
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y

    def split(self, f):
        return [_fresh(f.chunk(self.size, dim=1)[self.rank])]

    def gather(self, fs):
        (f,) = fs
        parts = [torch.empty_like(f) for _ in range(self.size)]
        dist.all_gather(parts, _fresh(f))
        return torch.cat(parts, dim=1)


def mesh_for(device, shards=None):
    """A sharded engine's default mesh: :meth:`DistMesh.from_env` where
    ``WORLD_SIZE`` is set (as under ``torchrun``) and no ``shards`` are
    asked for, else ``LocalMesh(shards)`` (one shard by default) on
    ``device``."""
    if shards is None and os.environ.get("WORLD_SIZE"):
        return DistMesh.from_env(device)
    return LocalMesh(1 if shards is None else shards, resolve_device(device))


def field_halos(mesh, states, fills, top_h: int, bot_h: int, fields):
    """Per field k of ``fields``, the (top, bot) ghost blocks of field k of
    every local shard's slab state (``fills[k]`` at the edges)."""
    return [mesh.halo([s[k] for s in states], fills[k], top_h, bot_h) for k in fields]
