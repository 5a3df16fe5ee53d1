"""The 2-D tile-mesh engine ``sharded_tile`` (port of
:mod:`ppsim_tpu.engines.sharded_tile`): the 2D slab grid cut along both bin
axes into Pr x Pc tiles over a 2-D mesh (``engines/mesh.py``), each tile
stepped by the tile forms of the kernels. The strips of ``sharded_grid``
exchange one ghost row per neighbour, O(cols) per shard against
O(rows_local * cols) of work; tiles scale by surface to volume, the
decomposition the reference's MPI write-up defers.

- **halo with corners**: the rows first, then the columns of the
  row-extended blocks (``LocalMesh.tile_halo``, the JAX ``_extend2``), so a
  ghost column carries the diagonal neighbour's corner bins with no
  diagonal send;
- **force**: every step each tile's boundary bins (xl, yl) go to its
  neighbours; K1's tile form reads the ghost rows and columns in its ring
  (owner-computes: each tile's sums equal the single-device kernel's);
- **migration** (``axes``): K2's tile form takes 1 ghost row above, 2 of xl
  and pid and 1 of the others below, and the columns its walk reads beside
  the tile (1 west, 2 east) over those rows. Both sides of a boundary, and
  all four tiles at a corner, settle the same predicates on the same bins,
  so a transfer needs no handshake;
- **migration** (``dirs9``): the torch ops' ``grid_ops.grid_rebin`` on each
  tile extended by a 2-bin ghost ring, with ``row0 - 2`` and ``col0 - 2``,
  in both impls. This is the JAX engine's design: it runs dirs9 on its XLA
  ghost-ring route even with ``impl="pallas"`` (``sharded_tile.py:
  343-381``: rebin moves are exact, so mixing routes keeps bitwise parity),
  and the JAX package has no Pallas kernel on that route, so K7 and K8 get
  no tile form;
- **monitors** are reduced over the mesh in int64
  (``sharded_grid.reduce_monitors``); the count planes cover own bins only.

``impl="cuda"`` (the default) runs the kernels' wrappers (the kernels on
CUDA tensors, their plain twins on CPU tensors); ``impl="plain"`` runs the
single-device engine's plain ops on each tile extended by its ghost ring
(the JAX package's ``impl="xla"``). An uncut column axis (Pc = 1) launches
the row-strip instances of the kernels exactly; an uncut row axis (Pr = 1)
is the column-only split.
"""

from __future__ import annotations

import dataclasses

import torch

from ppsim_tpu_torch.engines.base import register_engine
from ppsim_tpu_torch.engines.grid import GridEngine
from ppsim_tpu_torch.engines.mesh import mesh_factor, mesh_for
from ppsim_tpu_torch.engines.sharded_grid import ShardedGridEngine, reduce_monitors
from ppsim_tpu_torch.ops import grid_ops
from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda
from ppsim_tpu_torch.ops.cuda_rebin import rebin_axes_call_cuda
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, RebinMonitors, SlabState
from ppsim_tpu_torch.physics import accel_fn_for

__all__ = ["ShardedTileEngine", "ring_extend"]


def ring_extend(f, ghosts):
    """``f`` extended by its ghosts (top, bot, west, east), rows first; west
    and east None: by the rows only."""
    top, bot, west, east = ghosts
    f = torch.cat([top, f, bot], 1)
    return f if west is None else torch.cat([west, f, east], 2)


@register_engine
class ShardedTileEngine(ShardedGridEngine):
    """``sharded_tile`` on ``mesh`` (default: ``LocalMesh`` of ``shards`` on
    ``device`` in ``mesh_shape``, or, where ``WORLD_SIZE`` is set as under
    ``torchrun`` and no ``shards`` are asked for, :meth:`DistMesh.from_env`
    on that shape). ``mesh_shape`` (Pr, Pc) defaults to the near-square
    :func:`~ppsim_tpu_torch.engines.mesh.mesh_factor`; ``col_block`` is the
    column quantum of a tile (128 as in the JAX engine; tests shrink it so
    that small grids split in columns)."""

    name = "sharded_tile"

    def __init__(self, config, device="cuda", shards=None, mesh=None,
                 mesh_shape=None, col_block: int = 128, impl: str = "cuda"):
        if impl not in ("cuda", "plain"):
            raise ValueError(f"unknown sharded_tile impl {impl!r} (cuda | plain)")
        if mesh is None:
            mesh = mesh_for(device, shards, mesh_factor if mesh_shape is None else mesh_shape)
        # the strips' set-up of ShardedGridEngine does not apply: take the
        # GridEngine base directly
        GridEngine.__init__(self, config, device=mesh.device)
        self.mesh = mesh
        self.P = mesh.size
        self.Pr, self.Pc = mesh.shape
        self.impl = impl
        base = self.geom
        # rows a multiple of 8 and columns of col_block a tile (the JAX
        # engine's padding, kept so that both packages pick one geometry)
        self.rows_local = -(-base.rows // (self.Pr * 8)) * 8
        self.cols_local = -(-base.cols // (self.Pc * col_block)) * col_block
        self.geom = dataclasses.replace(base, rows_pad=self.Pr * self.rows_local,
                                        cols_pad=self.Pc * self.cols_local)

    def offsets(self, d: int):
        """Global (row, col) of tile ``d``'s first bin."""
        r, c = self.mesh.coords(d)
        return r * self.rows_local, c * self.cols_local

    def row0(self, d: int) -> int:
        return self.offsets(d)[0]

    def ghosts(self, shards, k: int, top_h: int, bot_h: int, west_w: int, east_w: int):
        """Per local tile, the (top, bot, west, east) ghosts of field ``k``
        (:meth:`~ppsim_tpu_torch.engines.mesh.LocalMesh.tile_halo`); on an
        uncut column axis west and east are None, and the kernels launch
        their row-strip instances."""
        fs = [s[k] for s in shards]
        if self.Pc > 1:
            return self.mesh.tile_halo(fs, SLAB_FILLS[k], top_h, bot_h, west_w, east_w)
        return [(t, b, None, None) for t, b in self.mesh.halo(fs, SLAB_FILLS[k], top_h, bot_h)]

    # ---- phases ------------------------------------------------------------
    def move_phase(self, shards):
        """Force + integrate on every tile; returns (shards, max_speed)."""
        mesh, cfg, geom = self.mesh, self.config, self.geom
        if self._phase_disable == "move":
            return shards, torch.zeros((), dtype=torch.float32, device=self.device)
        cols = self.Pc > 1
        gx, gy = (self.ghosts(shards, k, 1, 1, 1, 1) for k in (0, 1))
        out, speed = [], []
        for i, (s, d) in enumerate(zip(shards, mesh.shards)):
            r0, c0 = self.offsets(d)
            (tx, bx, wx, ex), (ty, by, wy, ey) = gx[i], gy[i]
            if self.impl == "plain":
                ax, ay = grid_ops.grid_force_xla(
                    ring_extend(s.xl, gx[i]), ring_extend(s.yl, gy[i]), geom, cfg.cutoff,
                    cfg.min_r, cfg.mass, pair_fn=accel_fn_for(cfg))
                inner = (slice(None), slice(1, -1), slice(1, -1) if cols else slice(None))
                new, ms = grid_ops.grid_move(s, (ax[inner], ay[inner]), geom, cfg.dt,
                                             cfg.size, row0=r0, col0=c0)
                out.append(new)
                speed.append(ms)
            else:
                xl, yl, vx, vy, sp2 = grid_step_cuda(
                    s.xl, s.yl, s.vx, s.vy, geom, cfg.cutoff, cfg.min_r, cfg.mass,
                    cfg.dt, cfg.size, law=cfg.force_law, law_params=cfg.law_params,
                    row0=r0, ghosts=(tx, ty, bx, by), col0=c0,
                    col_ghosts=(wx, wy, ex, ey) if cols else None)
                out.append(SlabState(xl, yl, vx, vy, s.pid))
                speed.append(sp2.max())
        max_speed = mesh.pmax(speed)
        if self.impl != "plain":  # sqrt after the max: monotone, so the same
            max_speed = torch.sqrt(max_speed)
        return out, max_speed

    def rebin_of(self, shards):
        """The rebin of every tile with its cross-tile migration; returns
        (shards, RebinMonitors) reduced over the mesh."""
        mesh, cfg, geom, evac = self.mesh, self.config, self.geom, self.config.evac_capacity
        if self._phase_disable == "rebin":
            z = torch.zeros((), dtype=torch.int32, device=self.device)
            return shards, RebinMonitors(z, z, z)
        offs = [self.offsets(d) for d in mesh.shards]
        if self.impl == "plain" or cfg.grid_rebin_mode == "dirs9":
            # the 2-bin ghost ring of every field: a destination's acceptance
            # needs its full neighbourhood (the JAX engine's XLA route)
            rebin = (grid_ops.grid_rebin_axes if cfg.grid_rebin_mode == "axes"
                     else grid_ops.grid_rebin)
            rings = [self.ghosts(shards, k, 2, 2, 2, 2) for k in range(5)]
            h = 2 if self.Pc > 1 else 0
            inner = (slice(None), slice(2, -2), slice(h, -h or None))
            out, cnt = [], []
            for i, (s, (r0, c0)) in enumerate(zip(shards, offs)):
                ext = SlabState(*(ring_extend(f, g[i]) for f, g in zip(s, rings)))
                new_ext, _ = rebin(ext, geom, evac, row0=r0 - 2, col0=c0 - h)
                new = SlabState(*(f[inner].contiguous() for f in new_ext))
                out.append(new)
                cnt.append(grid_ops.monitor_planes(s, new, geom, r0, c0))
            return out, reduce_monitors(mesh, cnt)
        # K2's walk reads fields at rows -1..+1 and the x masks at +2, and
        # the walk-settled columns -1..+2: one ghost row from above, from
        # below two of xl and pid and one of the others, and the columns of
        # those row-extended blocks, one west and two east
        halos = [self.ghosts(shards, k, 1, 2 if k in (0, 4) else 1, 1, 2) for k in range(5)]
        out, cnt = [], []
        for i, (s, (r0, c0)) in enumerate(zip(shards, offs)):
            new, c = rebin_axes_call_cuda(
                s, geom, evac, row0=r0, field_ghosts=[h[i][:2] for h in halos],
                col0=c0, col_ghosts=[h[i][2:] for h in halos] if self.Pc > 1 else None)
            out.append(new)
            cnt.append(c)
        return out, reduce_monitors(mesh, cnt)
