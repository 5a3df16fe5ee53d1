"""The shard forms of K1, K2, K7 and K8 (row offset and ghost rows) on the
card: each against its plain twin with the same ghosts, and against the
rows of the single-device kernel's output on the whole slab; and the
``sharded_grid`` engine against the single-device ``cuda`` engine. This
file imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_kernels.py

On the CPU every test skips (a CUDA kernel has no CPU mode). Tolerances: the
rebins bitwise; K1 against its twin at K1's (rtol 1e-5, atol 1e-6), and
bitwise against the single-device kernel (each particle's sum does not
depend on the split).
"""

import numpy as np
import pytest
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import shards_from_numpy, shards_to_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_cuda, rebin_axes_call_plain, rebin_counts_cuda, rebin_counts_plain,
    rebin_shuffle_cuda, rebin_shuffle_plain,
)
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabGeometry
from ppsim_tpu_torch.testing import SHARD_EDGE_GEOMETRY, shard_edge_slab

RTOL, ATOL = 1e-5, 1e-6
EVAC = 2
# 200 x 300 bins in 208 x 384, capacity 6: shards of 104 rows (P = 2), so a
# shard holds many of the kernels' segments.
LARGE = SlabGeometry(rows=200, cols=300, rows_pad=208, cols_pad=384, capacity=6,
                     bin_size=0.05)
# (geometry, shards, contention); SHARD_EDGE_GEOMETRY's last shard is ragged
# (rows 29-31 of 32 are padding) at P = 2 and 4.
CASES = {"edge-P2": (SHARD_EDGE_GEOMETRY, 2, False),
         "edge-P4": (SHARD_EDGE_GEOMETRY, 4, False),
         "contention-P4": (SHARD_EDGE_GEOMETRY, 4, True),
         "large-P2": (LARGE, 2, False)}
DENSE = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                  evac_capacity=2, rebin_every=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _equal(name, got, want):
    assert torch.equal(got, want), f"{name}: {int((got != want).sum())} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_shard_rebin_kernels_bitwise_on_card(cuda, case):
    geom, P, contention = CASES[case]
    slab = shard_edge_slab(geom, P, seed=P, contention=contention, device=cuda)
    shards = shards_from_numpy(*(t.cpu().numpy() for t in slab), P, device=cuda)
    mesh = LocalMesh(P, cuda)
    rl = geom.rows_pad // P
    # K2
    whole, whole_cnt = rebin_axes_call_cuda(slab, geom, EVAC)
    halos = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 2 if k in (0, 4) else 1)
             for k in range(5)]
    for d, s in enumerate(shards):
        kw = dict(row0=d * rl, field_ghosts=[h[d] for h in halos])
        got, cnt = rebin_axes_call_cuda(s, geom, EVAC, **kw)
        want, wcnt = rebin_axes_call_plain(s, geom, EVAC, **kw)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            _equal(f"K2 shard {d} plane {k} vs twin", g, w)
            _equal(f"K2 shard {d} plane {k} vs single device", g, f[:, d * rl:(d + 1) * rl])
        _equal(f"K2 shard {d} counts", cnt, wcnt)
        _equal(f"K2 shard {d} counts vs single device", cnt, whole_cnt[:, d * rl:(d + 1) * rl])
    # K7 + K8
    whole_counts = rebin_counts_cuda(slab, geom)
    whole, whole_cnt = rebin_shuffle_cuda(slab, whole_counts, geom, EVAC)
    counts = [rebin_counts_cuda(s, geom, row0=d * rl) for d, s in enumerate(shards)]
    fh = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 1) for k in range(5)]
    ch = mesh.halo(counts, 0, 2, 2)
    for d, s in enumerate(shards):
        _equal(f"K7 shard {d} vs twin", counts[d], rebin_counts_plain(s, geom, row0=d * rl))
        _equal(f"K7 shard {d} vs single device", counts[d],
               whole_counts[:, d * rl:(d + 1) * rl])
        kw = dict(row0=d * rl, field_ghosts=[h[d] for h in fh], count_ghosts=ch[d])
        got, cnt = rebin_shuffle_cuda(s, counts[d], geom, EVAC, **kw)
        want, wcnt = rebin_shuffle_plain(s, counts[d], geom, EVAC, **kw)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            _equal(f"K8 shard {d} plane {k} vs twin", g, w)
            _equal(f"K8 shard {d} plane {k} vs single device", g, f[:, d * rl:(d + 1) * rl])
        _equal(f"K8 shard {d} monitors", cnt, wcnt)
        _equal(f"K8 shard {d} monitors vs single device", cnt,
               whole_cnt[:, d * rl:(d + 1) * rl])
    assert int(whole_cnt[1].sum()) == int(whole_cnt[2].sum())  # nothing dropped


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_shard_step_kernel_on_card(cuda, P):
    eng = get_engine("sharded_grid", DENSE, device="cpu", shards=P)
    arrays = [a.copy() for a in shards_to_numpy(
        eng.init_carry(init_particles(DENSE, seed=42)).slab)]
    rng = np.random.default_rng(5)
    live = arrays[4] >= 0
    for k in (0, 1):
        arrays[k][live] += rng.uniform(-0.3, 0.3, live.sum()).astype(np.float32) * eng.geom.bin_size
    geom, rl = eng.geom, eng.rows_local
    shards = shards_from_numpy(*arrays, P, device=cuda)
    args = (geom, DENSE.cutoff, DENSE.min_r, DENSE.mass, DENSE.dt, DENSE.size)
    whole = grid_step_cuda(*(torch.from_numpy(a).to(cuda) for a in arrays[:4]), *args)
    mesh = LocalMesh(P, cuda)
    gx, gy = (mesh.halo([s[k] for s in shards], BIG, 1, 1) for k in (0, 1))
    for d, s in enumerate(shards):
        ghosts = (gx[d][0], gy[d][0], gx[d][1], gy[d][1])
        got = grid_step_cuda(*s[:4], *args, row0=d * rl, ghosts=ghosts)
        want = grid_step_plain(*s[:4], *args, row0=d * rl, ghosts=ghosts)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            assert torch.allclose(g, w, rtol=RTOL, atol=ATOL), (d, k)
            rows = f[:, d * rl:(d + 1) * rl] if f.dim() == 3 else f[d * rl:(d + 1) * rl]
            _equal(f"K1 shard {d} output {k} vs single device", g, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["axes", "dirs9"])
def test_sharded_engine_equals_cuda_engine_on_card(cuda, mode):
    cfg = DENSE.with_(grid_rebin_mode=mode)
    state = init_particles(cfg, seed=42, device=cuda)
    ref = get_engine("cuda", cfg, device=cuda).run(state, nsteps=24)
    for P in (2, 4):
        res = get_engine("sharded_grid", cfg, device=cuda, shards=P).run(state, nsteps=24)
        _equal(f"P={P} pos", res.state.pos, ref.state.pos)
        _equal(f"P={P} vel", res.state.vel, ref.state.vel)
        assert [float(m) for m in res.monitors] == [float(m) for m in ref.monitors]
