"""The shard transport of the sharded engines: a mesh of Pr x Pc shards
(the JAX package's ``shard_map`` over a ``Mesh`` with ``lax.ppermute`` /
``psum`` / ``pmax``: ``engines/sharded_grid.py:114-124`` for the 1-D mesh
of strips, ``engines/sharded_tile.py:108-110`` for the 2-D tile mesh).

Axis 0 of the mesh cuts dim 1 of the planes (2D rows, 3D y slabs), axis 1
cuts dim 2 (2D columns). A (P, 1) mesh is the 1-D mesh of P strips that
``sharded_grid`` and ``sharded_grid3d`` run on; ``sharded_tile`` runs on
(Pr, Pc). Shard d sits at mesh coordinates ``divmod(d, Pc)`` (row-major).

Two implementations of one interface. An engine holds the shards of its
process (``mesh.shards``: their global indices, 0..P-1 in all) and calls
the mesh with one tensor per local shard:

- :meth:`from_above` / :meth:`from_below` — each shard receives its
  neighbour's tensor along mesh axis 0 (from the shard above / below); the
  edge shard gets ``fill``;
- :meth:`halo` — both ghost blocks of a shard's planes along dim 1: the
  last ``top_h`` rows of the shard above and the first ``bot_h`` rows of
  the shard below ((k, R, C) planes in 2D, (k, Y, X, Z) in 3D);
- :meth:`tile_halo` — the ghost ring of a 2D tile with its corners: the
  rows first, then the columns of the row-extended blocks (the JAX
  ``_extend2``), so a ghost column carries the diagonal neighbour's corner
  bins with no diagonal send;
- :meth:`psum` / :meth:`pmax` — the sum / max over all shards, the same
  tensor in every process;
- :meth:`split` / :meth:`gather` — a global slab plane to the local shards
  (dim 1 in Pr parts, each part's dim 2 in Pc) and back.

:class:`LocalMesh` holds all shards in one process (the counterpart of the
JAX CLI's ``--cpu-mesh N``): each shard is a tensor of its own, and every
exchange copies into fresh buffers, as a receive would deliver them, so a
kernel can never read its neighbour's rows by accident. :class:`DistMesh`
runs over ``torch.distributed``, one shard a process (rank = the shard's
index): point-to-point sends through ``batch_isend_irecv`` and
``all_reduce`` for the reductions (gloo on the CPU, NCCL on cards).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ppsim_tpu_torch.engines.base import resolve_device

__all__ = ["LocalMesh", "DistMesh", "mesh_for", "mesh_factor", "field_halos"]


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in a buffer of its own."""
    return t.clone(memory_format=torch.contiguous_format)


def mesh_factor(n: int) -> Tuple[int, int]:
    """Near-square (rows, cols) factorization of ``n`` shards, rows-heavy
    (the JAX package's ``sharded_tile._mesh_factor``: the row axis has the
    finer alignment quantum, 8 against 128, so it splits with less
    padding)."""
    pc = int(math.sqrt(n))
    while n % pc:
        pc -= 1
    return (n // pc, pc)


def _shape_of(size) -> Tuple[int, int]:
    shape = (size, 1) if isinstance(size, int) else tuple(int(p) for p in size)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"a mesh needs at least one shard on each of two axes, "
                         f"got {size}")
    return shape


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


class _Mesh:
    """What both meshes share: the mesh's shape and the halos, built on each
    mesh's :meth:`exchange`."""

    def _init_shape(self, size) -> None:
        self.shape = _shape_of(size)
        self.size = self.shape[0] * self.shape[1]

    def coords(self, d: int) -> Tuple[int, int]:
        """Mesh coordinates (row, col) of shard ``d``."""
        return divmod(d, self.shape[1])

    def from_above(self, xs: Sequence[torch.Tensor], fill) -> List[torch.Tensor]:
        """Each shard gets the tensor of the shard above it (mesh axis 0; a
        fresh copy); the top row of shards ``fill``."""
        return self.exchange(xs, None, fill, 0)[0]

    def from_below(self, xs: Sequence[torch.Tensor], fill) -> List[torch.Tensor]:
        """Each shard gets the tensor of the shard below it; the bottom row
        of shards ``fill``."""
        return self.exchange(None, xs, fill, 0)[1]

    def halo(self, fs: Sequence[torch.Tensor], fill, top_h: int,
             bot_h: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(top, bot)`` ghost blocks of each shard's (k, R, ...) planes
        (cut along dim 1): ``top`` the last ``top_h`` rows of the shard
        above, ``bot`` the first ``bot_h`` rows of the shard below (``fill``
        at the edges)."""
        top, bot = self.exchange([f[:, -top_h:] for f in fs],
                                 [f[:, :bot_h] for f in fs], fill, 0)
        return list(zip(top, bot))

    def tile_halo(self, fs: Sequence[torch.Tensor], fill, top_h: int, bot_h: int,
                  west_w: int, east_w: int):
        """The ghost ring of each shard's (k, R, C) tile, corners included:
        ``(top, bot, west, east)`` with ``top`` / ``bot`` as :meth:`halo`
        gives them ((k, top_h, C), (k, bot_h, C)) and ``west`` / ``east``
        the last ``west_w`` / first ``east_w`` columns of the row-extended
        blocks of the shards beside ((k, top_h + R + bot_h, w)). The rows go
        first, then the columns (the JAX ``_extend2``): the lateral
        neighbour's row extension carries the diagonal neighbour's rows, so
        corners need no diagonal send. Only the edge columns of the
        row-extended blocks are assembled and sent, never a whole tile."""
        rows = self.halo(fs, fill, top_h, bot_h)

        def edge(f, tb, cols):
            return torch.cat([tb[0][..., cols], f[..., cols], tb[1][..., cols]], 1)

        west, east = self.exchange(
            [edge(f, tb, slice(f.shape[2] - west_w, None)) for f, tb in zip(fs, rows)],
            [edge(f, tb, slice(0, east_w)) for f, tb in zip(fs, rows)], fill, 1)
        return [(t, b, w, e) for (t, b), w, e in zip(rows, west, east)]


class LocalMesh(_Mesh):
    """All shards in one process, on ``device``: ``size`` = P (a (P, 1)
    mesh of strips) or (Pr, Pc)."""

    def __init__(self, size, device):
        self._init_shape(size)
        self.device = torch.device(device)
        self.shards = range(self.size)
        self._fill = _Fills()

    def _neighbour(self, d: int, axis: int, step: int):
        r, c = self.coords(d)
        r, c = (r + step, c) if axis == 0 else (r, c + step)
        inside = 0 <= r < self.shape[0] and 0 <= c < self.shape[1]
        return r * self.shape[1] + c if inside else None

    def exchange(self, fwd, bwd, fill, axis: int):
        """Along mesh ``axis``, each shard sends ``fwd`` (its tensor of that
        list) to the next shard and ``bwd`` to the previous one (either
        list may be None: nothing travels that way). Returns per shard
        ``(from_prev, from_next)``: fresh copies, ``fill`` at the edges."""
        out = []
        for xs, step in ((fwd, -1), (bwd, 1)):
            if xs is None:
                out.append(None)
                continue
            got = []
            for d in self.shards:
                n = self._neighbour(d, axis, step)
                got.append(self._fill(xs[d], fill) if n is None else _fresh(xs[n]))
            out.append(got)
        return tuple(out)

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs)).sum(dim=0)

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(xs)).amax(dim=0)

    def split(self, f: torch.Tensor) -> List[torch.Tensor]:
        """The shards' blocks of a (k, Pr * R, Pc * C, ...) plane, each in
        its own buffer, row-major."""
        pr, pc = self.shape
        return [_fresh(t) for rows in f.chunk(pr, dim=1) for t in rows.chunk(pc, dim=2)]

    def gather(self, fs: Sequence[torch.Tensor]) -> torch.Tensor:
        pc = self.shape[1]
        return torch.cat([torch.cat(list(fs[r:r + pc]), dim=2)
                          for r in range(0, len(fs), pc)], dim=1)


class DistMesh(_Mesh):
    """One shard a process, over the default ``torch.distributed`` process
    group (initialized by the caller, or by :meth:`from_env`), on a mesh of
    ``shape`` (default (world size, 1): strips); shard = rank, mesh
    coordinates row-major. Its tensors live on ``device``: the CPU under
    gloo, the process's card under NCCL."""

    def __init__(self, device, shape=None):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialized torch.distributed "
                               "process group")
        world = dist.get_world_size()
        self._init_shape(world if shape is None else shape)
        if self.size != world:
            raise ValueError(f"mesh {self.shape} needs {self.size} processes, "
                             f"the group has {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.shards = (self.rank,)
        self._fill = _Fills()

    @classmethod
    def from_env(cls, device="cuda", shape=None) -> "DistMesh":
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
        return cls(dev, shape)

    def exchange(self, fwd, bwd, fill, axis: int):
        """As :meth:`LocalMesh.exchange`, for this process's one shard:
        ``fwd`` goes to the next rank along mesh ``axis`` and ``bwd`` to the
        previous one, in one batch of point-to-point operations; each
        receive lands in a fresh buffer."""
        r, c = self.coords(self.rank)
        pos, n = (r, self.shape[0]) if axis == 0 else (c, self.shape[1])
        stride = self.shape[1] if axis == 0 else 1
        prev_rank = self.rank - stride if pos > 0 else None
        next_rank = self.rank + stride if pos < n - 1 else None
        out, ops = [None, None], []
        for i, (xs, src, dst) in enumerate(((fwd, prev_rank, next_rank),
                                            (bwd, next_rank, prev_rank))):
            if xs is None:
                continue
            (x,) = xs
            got = self._fill(x, fill)
            if src is not None:
                got = torch.empty_like(got)
                ops.append(dist.P2POp(dist.irecv, got, src))
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, _fresh(x), dst))
            out[i] = [got]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(out)

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
        r, c = self.coords(self.rank)
        pr, pc = self.shape
        return [_fresh(f.chunk(pr, dim=1)[r].chunk(pc, dim=2)[c])]

    def gather(self, fs):
        (f,) = fs
        parts = [torch.empty_like(f) for _ in range(self.size)]
        dist.all_gather(parts, _fresh(f))
        pc = self.shape[1]
        return torch.cat([torch.cat(parts[r:r + pc], dim=2)
                          for r in range(0, self.size, pc)], dim=1)


def mesh_for(device, shards=None, shape=None):
    """A sharded engine's default mesh: :meth:`DistMesh.from_env` where
    ``WORLD_SIZE`` is set (as under ``torchrun``) and no ``shards`` are
    asked for, else ``LocalMesh`` of ``shards`` on ``device``. ``shape`` is
    the mesh's (Pr, Pc), which also gives the shard count, or a function of
    the shard count that gives it; by default (P, 1), strips, of one shard
    unless asked for more."""
    distributed = shards is None and bool(os.environ.get("WORLD_SIZE"))
    if shape is None or callable(shape):
        n = (int(os.environ["WORLD_SIZE"]) if distributed
             else 1 if shards is None else shards)
        shape = (n, 1) if shape is None else shape(n)
    shape = _shape_of(shape)
    if shards is not None and shards != shape[0] * shape[1]:
        raise ValueError(f"mesh shape {shape} does not hold {shards} shards")
    if distributed:
        return DistMesh.from_env(device, shape)
    return LocalMesh(shape, resolve_device(device))


def field_halos(mesh, states, fills, top_h: int, bot_h: int, fields):
    """Per field k of ``fields``, the (top, bot) ghost blocks of field k of
    every local shard's slab state (``fills[k]`` at the edges)."""
    return [mesh.halo([s[k] for s in states], fills[k], top_h, bot_h) for k in fields]
