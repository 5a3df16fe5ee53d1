"""``sharded_grid`` over ``torch.distributed``: ``DistMesh`` under gloo with
two CPU processes equals ``LocalMesh(2)`` in one process, bitwise, in both
rebin modes and on a saved run. The processes meet through a ``FileStore``
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

WORLD = 2
TIMEOUT_S = 120
CFG = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                evac_capacity=2, rebin_every=4)
STEPS, SAVEFREQ = 13, 4


def _run(cfg, mesh=None, shards=None):
    torch.set_num_threads(1)
    eng = get_engine("sharded_grid", cfg, device="cpu", mesh=mesh, shards=shards)
    return eng.run(init_particles(cfg, seed=3), nsteps=STEPS, savefreq=SAVEFREQ)


def _worker(rank, store_path, mode, out_path):
    import torch.distributed as dist

    from ppsim_tpu_torch.engines.mesh import DistMesh

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        mesh = DistMesh("cpu")
        mine = torch.full((1, 1, 2), float(rank))
        nbrs = [mesh.from_above([mine], -1.0)[0], mesh.from_below([mine], -1.0)[0]]
        res = _run(CFG.with_(grid_rebin_mode=mode), mesh=mesh)
        np.savez(f"{out_path}.{rank}.npz", pos=res.state.pos.numpy(),
                 vel=res.state.vel.numpy(), frames=res.frames,
                 monitors=np.array([float(m) for m in res.monitors]),
                 nbrs=np.array([float(t.flatten()[0]) for t in nbrs]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["axes", "dirs9"])
def test_dist_mesh_gloo_equals_local_mesh(tmp_path, mode):
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "run")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp_path / "store"), mode, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f"processes {hung} still running after {TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    want = _run(CFG.with_(grid_rebin_mode=mode), shards=WORLD)
    for rank in range(WORLD):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_array_equal(got["pos"], want.state.pos.numpy())
        np.testing.assert_array_equal(got["vel"], want.state.vel.numpy())
        np.testing.assert_array_equal(got["frames"], want.frames)
        np.testing.assert_array_equal(got["monitors"],
                                      [float(m) for m in want.monitors])
        # from_above / from_below: the neighbour's rank, -1 past the edges
        above, below = rank - 1, (rank + 1 if rank + 1 < WORLD else -1)
        np.testing.assert_array_equal(got["nbrs"], [above, below])
