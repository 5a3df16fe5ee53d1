"""The pair counts of the 3D step (``counts`` of K3's wrapper and its plain
twin, ``Counters.pair_hits`` and ``coef_warp_passes``) on the CPU:

- the plain twin's count of pairs inside the cutoff against a brute-force
  count over all particle pairs in float64 (self pairs included, dead slots
  excluded) on small seeded gases, with both laws, and in its shard form
  with ghost slabs;
- the engines that run K3's wrapper (``cuda3d``, ``sharded_grid3d``) fill
  ``Counters.record()["pair_hits"]`` once a run, counting the steps run
  inside ``profiling.tracing()`` and no others; ``coef_warp_passes``,
  ``pair_tests`` and ``test_warp_passes``, which only K3 counts, stay 0 off
  the card.

The card's side (K3's counts equal to the twin's) is in
tests/test_torch_kernels.py and tests/test_torch_sharded_kernels.py.
"""

import numpy as np
import pytest
import torch

from ppsim_tpu_torch import profiling
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.cuda_grid import pair_args
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain, new_counts
from ppsim_tpu_torch.ops.grid3d_ops import Slab3State
from ppsim_tpu_torch.testing import gas_slab3, gas_state3

# n = 500 at density 7e-6: 6^3 bins of 3 cutoffs, ~0.6 neighbours inside the
# cutoff a particle in a uniform gas.
GAS3 = SimConfig(num_parts=500, ndim=3, density=7e-6, grid3_spill=False)
LAWS = {"repulsive": {}, "lj": dict(force_law="lj", dt=1e-4)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _c2(cfg) -> float:
    return pair_args(cfg.force_law, cfg.cutoff, cfg.min_r, cfg.mass, cfg.law_params)[1]


def brute_force_hits(pos: np.ndarray, c2: float) -> int:
    """Ordered pairs (i, j) of the particles ``pos`` (float64, (n, 3)) with
    |p_j - p_i|^2 <= c2, i == j included. No pair may lie within 1e-5 of
    c2, where the twin's float32 rounding could decide otherwise."""
    d = pos[:, None, :] - pos[None, :, :]
    r2 = (d * d).sum(-1)
    assert not (np.abs(r2 - c2) < 1e-5 * c2).any(), "a pair on the cutoff's edge"
    return int((r2 <= c2).sum())


def _step_args(cfg, geom):
    return (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size,
            cfg.force_law, cfg.law_params)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_plain_twin_counts_the_pairs_inside_the_cutoff(law, seed):
    cfg = GAS3.with_(**LAWS[law])
    geom, slab, pos = gas_slab3(cfg, seed)
    want = brute_force_hits(pos, _c2(cfg))
    assert want > 1.3 * cfg.num_parts  # neighbours in range, not only self pairs
    counts = new_counts("cpu")
    out = grid3_step_plain(*slab[:6], *_step_args(cfg, geom), counts=counts)
    assert counts.tolist() == [want, 0, 0, 0]
    # counting changes nothing the step returns, and the wrapper counts alike
    for a, b in zip(out, grid3_step_plain(*slab[:6], *_step_args(cfg, geom))):
        assert torch.equal(a, b)
    again = new_counts("cpu")
    grid3_step_cuda(*slab[:6], *_step_args(cfg, geom), counts=again)
    assert torch.equal(again, counts)


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_shard_twin_counts_each_pair_once_over_the_strips(law, P):
    """Strips of the gas slab with their ghost slabs: every own particle's
    pairs, those across a boundary included, counted once by its strip."""
    cfg = GAS3.with_(**LAWS[law])
    geom, slab, pos = gas_slab3(cfg, 2)
    Y = geom.ys_pad
    yl = -(-Y // P)
    pad = P * yl - Y  # extend to whole strips with empty slabs
    fields = [torch.cat([f, torch.full((f.shape[0], pad, *f.shape[2:]),
                                       BIG if k < 3 else 0, dtype=f.dtype)], 1)
              for k, f in enumerate(slab[:6])]
    mesh = LocalMesh(P, "cpu")
    strips = [Slab3State(*fs, None) for fs in zip(*(mesh.split(f) for f in fields))]
    halos = [mesh.halo([s[k] for s in strips], BIG, 1, 1) for k in range(3)]
    counts, crossing = new_counts("cpu"), 0
    for d, s in enumerate(strips):
        ghosts = tuple(h[d][0] for h in halos) + tuple(h[d][1] for h in halos)
        before = int(counts[0])
        grid3_step_plain(*s[:6], *_step_args(cfg, geom), y0=d * yl, ghosts=ghosts,
                         counts=counts)
        alone = new_counts("cpu")
        grid3_step_plain(*s[:6], *_step_args(cfg, geom), y0=d * yl, counts=alone)
        crossing += int(counts[0]) - before - int(alone[0])
    assert int(counts[0]) == brute_force_hits(pos, _c2(cfg))
    assert crossing > 0  # pairs across a strip boundary exist, and count


@pytest.mark.parametrize("name", ["cuda3d", "sharded_grid3d"])
def test_engine_runs_fill_the_pair_counters(name):
    cfg = GAS3.with_(**LAWS["lj"])
    state = gas_state3(cfg, 3)
    want = brute_force_hits(state.pos.double().numpy(), _c2(cfg))
    kw = {"shards": 2} if name == "sharded_grid3d" else {}
    eng = get_engine(name, cfg, device="cpu", **kw)
    with profiling.tracing():
        eng.run(state, nsteps=1)
    record = eng.counters.record()
    assert (record["pair_hits"], record["coef_warp_passes"]) == (want, 0)
    eng.run(state, nsteps=1)  # outside tracing() nothing counts
    assert (eng.counters.pair_hits, eng.counters.runs) == (want, 2)
    with profiling.tracing():  # the totals of the engine's life, read once a run
        eng.run(state, nsteps=1)
    assert (eng.counters.pair_hits, eng.counters.coef_warp_passes) == (2 * want, 0)
