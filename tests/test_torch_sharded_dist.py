"""``sharded_grid``, ``sharded_grid3d``, ``sharded_tile`` and the
particle-list ``sharded`` over ``torch.distributed``: ``DistMesh`` under
gloo with two CPU processes equals ``LocalMesh(2)`` in one process, bitwise,
in both 2D rebin modes, in 3D and on the particle list,
and with four processes on a 2 x 2 mesh equals ``LocalMesh((2, 2))``, on a
saved run. The processes meet through a ``FileStore``
in the test's own directory (no TCP port, so parallel test workers cannot
collide), and each has a hard time limit after which the test fails.

This file imports no JAX: the spawned processes import it."""

import multiprocessing

import numpy as np
import pytest
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.initlib import init_particles

TIMEOUT_S = 120
CFG = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                evac_capacity=2, rebin_every=4)
# 3D: the JAX package's 3D test config, y strips of 3 slabs.
CFG3 = SimConfig(num_parts=400, ndim=3, density=7e-6, grid3_capacity=8,
                 evac_capacity=2, rebin3_every=4)
STEPS, SAVEFREQ = 13, 4
# The mesh of each mode: 2 strips, or 2 x 2 tiles (col_block 8 splits the
# 41 x 41 bins of CFG into tiles of 24 x 24).
SHAPES = {"axes": (2, 1), "dirs9": (2, 1), "3d": (2, 1), "tile": (2, 2),
          "particle": (2, 1)}


def _run(mode, mesh=None, shards=None):
    """The run of ``mode``: a 2D rebin mode on sharded_grid, "3d" on
    sharded_grid3d, "tile" on sharded_tile (axes), or "particle" on the
    particle-list sharded."""
    torch.set_num_threads(1)
    kw = dict(device="cpu", mesh=mesh, shards=shards)
    if mode == "particle":
        name, cfg = "sharded", CFG
    elif mode == "tile":
        name, cfg = "sharded_tile", CFG
        kw.update(mesh_shape=None if shards is None else SHAPES[mode], col_block=8)
    else:
        name, cfg = (("sharded_grid3d", CFG3) if mode == "3d"
                     else ("sharded_grid", CFG.with_(grid_rebin_mode=mode)))
    eng = get_engine(name, cfg, **kw)
    return eng.run(init_particles(cfg, seed=3), nsteps=STEPS, savefreq=SAVEFREQ)


def _worker(rank, store_path, mode, out_path):
    import torch.distributed as dist

    from ppsim_tpu_torch.engines.mesh import DistMesh

    world = SHAPES[mode][0] * SHAPES[mode][1]
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = DistMesh("cpu", SHAPES[mode])
        mine = torch.full((1, 1, 2), float(rank))
        nbrs = [mesh.from_above([mine], -1.0)[0], mesh.from_below([mine], -1.0)[0],
                *(t[0] for t in mesh.exchange([mine], [mine], -1.0, 1))]
        res = _run(mode, mesh=mesh)
        np.savez(f"{out_path}.{rank}.npz", pos=res.state.pos.numpy(),
                 vel=res.state.vel.numpy(), frames=res.frames,
                 monitors=np.array([float(m) for m in res.monitors]),
                 nbrs=np.array([float(t.flatten()[0]) for t in nbrs]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["axes", "dirs9", "3d", "tile", "particle"])
def test_dist_mesh_gloo_equals_local_mesh(tmp_path, mode):
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "run")
    pr, pc = SHAPES[mode]
    world = pr * pc
    procs = [ctx.Process(target=_worker, args=(r, str(tmp_path / "store"), mode, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f"processes {hung} still running after {TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    want = _run(mode, shards=world)
    for rank in range(world):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_array_equal(got["pos"], want.state.pos.numpy())
        np.testing.assert_array_equal(got["vel"], want.state.vel.numpy())
        np.testing.assert_array_equal(got["frames"], want.frames)
        np.testing.assert_array_equal(got["monitors"],
                                      [float(m) for m in want.monitors])
        # from_above / from_below and the exchange along the mesh's columns:
        # the neighbour's rank, -1 past the edges
        r, c = divmod(rank, pc)
        want_nbrs = [rank - pc if r > 0 else -1, rank + pc if r < pr - 1 else -1,
                     rank - 1 if c > 0 else -1, rank + 1 if c < pc - 1 else -1]
        np.testing.assert_array_equal(got["nbrs"], want_nbrs)
