"""The shard forms of K1, K2, K7 and K8 (row offset and ghost rows), of K3,
K4 and K5 (y offset and ghost y slabs) and the tile forms of K1 and K2 (row
and column offsets, ghost rows and columns) on the card: each against its
plain twin with the same ghosts, and against the rows (bins) of the
single-device kernel's output on the whole slab; the entry points' refusal
of half the ghosts; and the ``sharded_grid``, ``sharded_grid3d`` and
``sharded_tile`` engines against the single-device ``cuda`` and ``cuda3d``
engines. This file imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_kernels.py

On the CPU every test skips (a CUDA kernel has no CPU mode). Tolerances: the
rebins bitwise; K1 and K3 against their twins at their own (rtol 1e-5, atol
1e-6), and bitwise against the single-device kernel (each particle's sum
does not depend on the split).
"""

import numpy as np
import pytest
import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import (
    shards3_from_numpy, shards_from_numpy, shards_to_numpy, tiles_from_numpy, tiles_to_numpy,
)
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain, new_counts
from ppsim_tpu_torch.ops.cuda_rebin3 import (
    rebin3_inplane_cuda, rebin3_inplane_plain, rebin3_ypass_cuda, rebin3_ypass_plain,
)
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_cuda, rebin_axes_call_plain, rebin_counts_cuda, rebin_counts_plain,
    rebin_shuffle_cuda, rebin_shuffle_plain,
)
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid3d_ops import FILLS3, Geometry3S, Slab3State
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabGeometry, f32
from ppsim_tpu_torch.testing import (
    SHARD_EDGE_GEOMETRY, SHARD_EDGE_GEOMETRY3, TILE_EDGE_GEOMETRY, gas_state3,
    shard_edge_slab, shard_edge_slab3, tile_edge_slab,
)

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


# 3D: 40 x 20 x 100 bins in 40 x 24 x 128, capacity 6: shards of 20 y slabs
# (P = 2), each many of K3's segments; SHARD_EDGE_GEOMETRY3's last shard is
# ragged (slab 11 of 12 is padding) at P = 2 and 4.
LARGE3 = Geometry3S(ys=40, xs=20, zs=100, ys_pad=40, xs_pad=24, zs_pad=128,
                    capacity=6, bsy=0.05, bsx=0.04, bsz=0.03)
CASES3 = {"edge-P2": (SHARD_EDGE_GEOMETRY3, 2, False),
          "edge-P4": (SHARD_EDGE_GEOMETRY3, 4, False),
          "contention-P4": (SHARD_EDGE_GEOMETRY3, 4, True),
          "large-P2": (LARGE3, 2, False)}
CFG3 = SimConfig(num_parts=400, ndim=3, density=7e-6, grid3_capacity=8,
                 evac_capacity=2, rebin3_every=4)


def _rebin3_shards(geom, P, contention, device):
    slab = shard_edge_slab3(geom, P, seed=P, contention=contention, device=device)
    return slab, shards3_from_numpy(*(t.cpu().numpy() for t in slab), P, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES3))
def test_shard_rebin3_kernels_bitwise_on_card(cuda, case):
    """K4 with y0, then K5 with y0 and the ghosts of K4's output, against
    their twins and the rows of the single-device K4 and K5."""
    geom, P, contention = CASES3[case]
    slab, shards = _rebin3_shards(geom, P, contention, cuda)
    mesh = LocalMesh(P, cuda)
    yl = geom.ys_pad // P
    wmid, wcnt = rebin3_inplane_cuda(slab, geom, EVAC)
    whole, wpost = rebin3_ypass_cuda(wmid, wcnt, geom, EVAC)
    mids = []
    for d, s in enumerate(shards):
        mid, cnt = rebin3_inplane_cuda(s, geom, EVAC, y0=d * yl)
        want = rebin3_inplane_plain(s, geom, EVAC, y0=d * yl)
        for k, (g, w, f) in enumerate(zip((*mid, cnt), (*want[0], want[1]), (*wmid, wcnt))):
            _equal(f"K4 shard {d} output {k} vs twin", g, w)
            _equal(f"K4 shard {d} output {k} vs single device", g, f[:, d * yl:(d + 1) * yl])
        mids.append((mid, cnt))
    fh = [mesh.halo([m[k] for m, _ in mids], FILLS3[k], 1, 1) for k in range(7)]
    ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
    for d, (mid, cnt) in enumerate(mids):
        kw = dict(y0=d * yl, field_ghosts=[h[d] for h in fh], count_ghosts=ch[d])
        got, post = rebin3_ypass_cuda(mid, cnt, geom, EVAC, **kw)
        want, wp = rebin3_ypass_plain(mid, cnt, geom, EVAC, **kw)
        for k, (g, w, f) in enumerate(zip((*got, post), (*want, wp), (*whole, wpost))):
            _equal(f"K5 shard {d} output {k} vs twin", g, w)
            _equal(f"K5 shard {d} output {k} vs single device", g, f[:, d * yl:(d + 1) * yl])
    assert int(wcnt[3].sum()) == 0 and int(wcnt[4].sum()) == int(wpost[0].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_shard_step3_kernel_on_card(cuda, P, law):
    cfg = CFG3 if law == "repulsive" else CFG3.with_(force_law="lj", dt=1e-4)
    eng = get_engine("sharded_grid3d", cfg, device="cpu", shards=P)
    arrays = [a.copy() for a in shards_to_numpy(
        eng.init_carry(init_particles(cfg, seed=42, method="fast")).slab)]
    rng = np.random.default_rng(5)
    live = arrays[6] >= 0
    geom, yl = eng.geom, eng.ys_local
    for k, bs in enumerate((geom.bsx, geom.bsy, geom.bsz)):
        arrays[k][live] += rng.uniform(-0.2, 0.2, live.sum()).astype(np.float32) * bs
    shards = shards3_from_numpy(*arrays, P, device=cuda)
    args = (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size, law, cfg.law_params)
    whole = grid3_step_cuda(*(torch.from_numpy(a).to(cuda) for a in arrays[:6]), *args)
    mesh = LocalMesh(P, cuda)
    halos = [mesh.halo([s[k] for s in shards], BIG, 1, 1) for k in range(3)]
    for d, s in enumerate(shards):
        ghosts = tuple(h[d][0] for h in halos) + tuple(h[d][1] for h in halos)
        got = grid3_step_cuda(*s[:6], *args, y0=d * yl, ghosts=ghosts)
        want = grid3_step_plain(*s[:6], *args, y0=d * yl, ghosts=ghosts)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            assert torch.allclose(g, w, rtol=RTOL, atol=ATOL), (d, k)
            rows = f[:, d * yl:(d + 1) * yl] if f.dim() == 4 else f[d * yl:(d + 1) * yl]
            _equal(f"K3 shard {d} output {k} vs single device", g, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_shard_step3_kernel_counts_pairs_on_card(cuda, P, law):
    """K3's SHARD instance counts each strip's own pairs inside the cutoff,
    those across a boundary included: over the strips, the single-device
    kernel's count and the twin's with the same ghosts."""
    cfg = SimConfig(num_parts=500, ndim=3, density=7e-6, grid3_spill=False)
    cfg = cfg.with_(force_law="lj", dt=1e-4) if law == "lj" else cfg
    eng = get_engine("sharded_grid3d", cfg, device="cpu", shards=P)
    carry = eng.init_carry(gas_state3(cfg, 6))
    shards = [Slab3State(*(t.to(cuda) for t in s)) for s in carry.slab]
    whole = eng.full_slab(carry)
    geom, yl = eng.geom, eng.ys_local
    args = (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size, law, cfg.law_params)
    single = new_counts(cuda)
    grid3_step_cuda(*(t.to(cuda) for t in whole[:6]), *args, counts=single)
    halos = [LocalMesh(P, cuda).halo([s[k] for s in shards], BIG, 1, 1) for k in range(3)]
    counts, twin = new_counts(cuda), new_counts(cuda)
    for d, s in enumerate(shards):
        ghosts = tuple(h[d][0] for h in halos) + tuple(h[d][1] for h in halos)
        grid3_step_cuda(*s[:6], *args, y0=d * yl, ghosts=ghosts, counts=counts)
        grid3_step_plain(*s[:6], *args, y0=d * yl, ghosts=ghosts, counts=twin)
    assert int(counts[0]) == int(single[0]) == int(twin[0]) > 500
    assert 32 * int(counts[1]) >= int(counts[0])


@pytest.mark.cuda
def test_shard3_entry_points_refuse_half_the_ghosts(cuda):
    """K3's wrapper takes all six ghost planes and K5's its field and count
    ghosts together; their C entry points return cudaErrorInvalidValue (1)
    for one side's ghosts without the other's, and write nothing."""
    geom, P = SHARD_EDGE_GEOMETRY3, 2
    slab, shards = _rebin3_shards(geom, P, False, cuda)
    s = shards[0]
    cap, Y, X, Z = s.xl.shape
    ghost = torch.full((cap, 1, X, Z), BIG, device=cuda)
    step_args = (geom, CFG3.cutoff, CFG3.min_r, CFG3.mass, CFG3.dt, CFG3.size)
    with pytest.raises(ValueError, match="6 ghost planes"):
        grid3_step_cuda(*s[:6], *step_args, ghosts=(ghost,) * 3)
    mid, cnt = rebin3_inplane_cuda(s, geom, EVAC)
    fh = LocalMesh(P, cuda).halo([mid.xl, mid.xl], BIG, 1, 1)
    with pytest.raises(ValueError, match="together"):
        rebin3_ypass_cuda(mid, cnt, geom, EVAC, field_ghosts=[fh[0]] * 7)
    lib = _build.kernels()
    out = [torch.full_like(t, 7) for t in mid]
    post = torch.full((2, Y, X, Z), 7, dtype=torch.int32, device=cuda)
    pid_ghost = torch.full((cap, 1, X, Z), -1, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # K5: field ghosts above and below, no count ghosts
    err = lib.ppsim_rebin3_ypass(
        *(t.data_ptr() for t in (*mid, cnt)), *(ghost.data_ptr(),) * 6, pid_ghost.data_ptr(),
        *(ghost.data_ptr(),) * 6, pid_ghost.data_ptr(), 0, 0,
        *(t.data_ptr() for t in (*out, post)), cuda.index, cap, Y, X, Z, 0, geom.ys,
        geom.xs, geom.zs, EVAC, f32(geom.bsy), f32(1.0 / geom.bsx), f32(1.0 / geom.bsy),
        f32(1.0 / geom.bsz), stream)
    torch.cuda.synchronize()
    assert err == 1
    # K3: the top ghost slab's x without its y and z
    from ppsim_tpu_torch.ops.cuda_grid import pair_args
    from ppsim_tpu_torch.ops.cuda_grid3 import step3_plan

    plan = step3_plan((cap, Y, X, Z))
    sp = torch.full((Y, X, Z), 7.0, device=cuda)
    err = lib.ppsim_grid3_step(
        *(t.data_ptr() for t in s[:6]), ghost.data_ptr(), *(0,) * 5,
        *(t.data_ptr() for t in out[:6]), sp.data_ptr(), 0, cuda.index, cap, Y, X, Z, 0,
        geom.xs, geom.zs, *pair_args("repulsive", CFG3.cutoff, CFG3.min_r, CFG3.mass, ())[:1],
        *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem, f32(geom.bsx),
        f32(geom.bsy), f32(geom.bsz),
        *pair_args("repulsive", CFG3.cutoff, CFG3.min_r, CFG3.mass, ())[1:],
        f32(CFG3.dt), f32(CFG3.size), stream)
    torch.cuda.synchronize()
    assert err == 1
    for a in (*out, post, sp):
        assert bool((a == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_sharded_grid3d_equals_cuda3d_on_card(cuda, law):
    cfg = CFG3 if law == "repulsive" else CFG3.with_(force_law="lj", dt=1e-4)
    state = init_particles(cfg, seed=42, method="fast", device=cuda)
    ref = get_engine("cuda3d", cfg, device=cuda).run(state, nsteps=24)
    for P in (2, 4):
        res = get_engine("sharded_grid3d", cfg, device=cuda, shards=P).run(state, nsteps=24)
        _equal(f"P={P} pos", res.state.pos, ref.state.pos)
        _equal(f"P={P} vel", res.state.vel, ref.state.vel)
        assert [float(m) for m in res.monitors] == [float(m) for m in ref.monitors]


# Tiles: (geometry, mesh shape, contention). TILE_EDGE_GEOMETRY's last row
# and column of tiles are ragged; LARGE's 2 x 2 tiles of 104 x 192 hold many
# of K1's and K2's strips and segments.
# RAGGED's tiles are 80 columns wide: K2's third strip of 32 is ragged, so
# its east ghost columns sit inside the strip.
RAGGED = SlabGeometry(rows=29, cols=150, rows_pad=32, cols_pad=160, capacity=4,
                      bin_size=0.05)
TILE_CASES = {"edge-2x2": (TILE_EDGE_GEOMETRY, (2, 2), False),
              "contention-1x4": (TILE_EDGE_GEOMETRY, (1, 4), True),
              "large-2x2": (LARGE, (2, 2), False),
              "ragged-2x2": (RAGGED, (2, 2), False)}


def _tile_cut(shape, d, R, C):
    r, c = divmod(d, shape[1])
    rl, cl = R // shape[0], C // shape[1]
    return (slice(None), slice(r * rl, (r + 1) * rl), slice(c * cl, (c + 1) * cl)), r * rl, c * cl


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_rebin_kernel_bitwise_on_card(cuda, case):
    """K2 with row0, col0, its ghost rows and its ghost columns (1 west, 2
    east, over rows -1..R+1) on every tile, against its twin and the bins of
    the single-device K2 on the whole slab."""
    geom, shape, contention = TILE_CASES[case]
    slab = tile_edge_slab(geom, shape, seed=2, contention=contention, device=cuda)
    tiles = tiles_from_numpy(*(t.cpu().numpy() for t in slab), shape, device=cuda)
    mesh = LocalMesh(shape, cuda)
    whole, whole_cnt = rebin_axes_call_cuda(slab, geom, EVAC)
    halos = [mesh.tile_halo([t[k] for t in tiles], SLAB_FILLS[k], 1,
                            2 if k in (0, 4) else 1, 1, 2) for k in range(5)]
    for d, t in enumerate(tiles):
        cut, r0, c0 = _tile_cut(shape, d, *geom.shape[1:])
        kw = dict(row0=r0, field_ghosts=[h[d][:2] for h in halos], col0=c0,
                  col_ghosts=[h[d][2:] for h in halos])
        got, cnt = rebin_axes_call_cuda(t, geom, EVAC, **kw)
        want, wcnt = rebin_axes_call_plain(t, geom, EVAC, **kw)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            _equal(f"K2 tile {d} plane {k} vs twin", g, w)
            _equal(f"K2 tile {d} plane {k} vs single device", g, f[cut])
        _equal(f"K2 tile {d} counts", cnt, wcnt)
        _equal(f"K2 tile {d} counts vs single device", cnt, whole_cnt[cut])
    assert int(whole_cnt[1].sum()) == int(whole_cnt[2].sum())  # nothing dropped
    if contention:
        assert int(whole_cnt[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_tile_step_kernel_on_card(cuda, shape):
    """K1 with row0, col0, ghost rows and ghost columns on every tile of
    DENSE's drifted slab: allclose to its twin, bitwise the single-device
    K1's bins."""
    eng = get_engine("sharded_tile", DENSE, device="cpu", mesh_shape=shape, col_block=8)
    arrays = [a.copy() for a in tiles_to_numpy(
        eng.init_carry(init_particles(DENSE, seed=42)).slab, shape)]
    rng = np.random.default_rng(5)
    live = arrays[4] >= 0
    for k in (0, 1):
        arrays[k][live] += rng.uniform(-0.3, 0.3, live.sum()).astype(np.float32) * eng.geom.bin_size
    geom = eng.geom
    tiles = tiles_from_numpy(*arrays, shape, device=cuda)
    args = (geom, DENSE.cutoff, DENSE.min_r, DENSE.mass, DENSE.dt, DENSE.size)
    whole = grid_step_cuda(*(torch.from_numpy(a).to(cuda) for a in arrays[:4]), *args)
    mesh = LocalMesh(shape, cuda)
    gx, gy = (mesh.tile_halo([t[k] for t in tiles], BIG, 1, 1, 1, 1) for k in (0, 1))
    for d, t in enumerate(tiles):
        cut, r0, c0 = _tile_cut(shape, d, *geom.shape[1:])
        (tx, bx, wx, ex), (ty, by, wy, ey) = gx[d], gy[d]
        kw = dict(row0=r0, ghosts=(tx, ty, bx, by), col0=c0, col_ghosts=(wx, wy, ex, ey))
        got = grid_step_cuda(*t[:4], *args, **kw)
        want = grid_step_plain(*t[:4], *args, **kw)
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            assert torch.allclose(g, w, rtol=RTOL, atol=ATOL), (d, k)
            _equal(f"K1 tile {d} output {k} vs single device", g, f[cut] if f.dim() == 3
                   else f[cut[1:]])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["axes", "dirs9"])
def test_sharded_tile_equals_cuda_engine_on_card(cuda, mode):
    cfg = DENSE.with_(grid_rebin_mode=mode)
    state = init_particles(cfg, seed=42, device=cuda)
    ref = get_engine("cuda", cfg, device=cuda).run(state, nsteps=24)
    for shape in ((2, 2), (1, 4), (4, 1)):
        res = get_engine("sharded_tile", cfg, device=cuda, mesh_shape=shape,
                         col_block=8).run(state, nsteps=24)
        _equal(f"{shape} pos", res.state.pos, ref.state.pos)
        _equal(f"{shape} vel", res.state.vel, ref.state.vel)
        assert [float(m) for m in res.monitors] == [float(m) for m in ref.monitors]


@pytest.mark.cuda
def test_tile_entry_points_refuse_columns_without_rows(cuda):
    """Ghost columns need the ghost rows: the wrappers raise, and K1's and
    K2's C entry points return cudaErrorInvalidValue (1) and write nothing."""
    geom, shape = TILE_EDGE_GEOMETRY, (1, 4)
    slab = tile_edge_slab(geom, shape, seed=1, device=cuda)
    t = tiles_from_numpy(*(a.cpu().numpy() for a in slab), shape, device=cuda)[1]
    cap, R, C = t.xl.shape
    col = torch.full((cap, R + 2, 1), BIG, device=cuda)
    step_args = (geom, DENSE.cutoff, DENSE.min_r, DENSE.mass, DENSE.dt, DENSE.size)
    with pytest.raises(ValueError, match="ghost rows"):
        grid_step_cuda(*t[:4], *step_args, col0=C, col_ghosts=(col,) * 4)
    with pytest.raises(ValueError, match="ghost rows"):
        rebin_axes_call_cuda(t, geom, EVAC, col0=C, col_ghosts=[(col, col)] * 5)
    from ppsim_tpu_torch.ops.cuda_grid import pair_args, step_plan
    from ppsim_tpu_torch.ops.cuda_rebin import rebin_plan

    lib = _build.kernels()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out = [torch.full_like(a, 7) for a in t]
    sp = torch.full((R, C), 7.0, device=cuda)
    plan = step_plan((cap, R, C))
    law, *consts = pair_args("repulsive", DENSE.cutoff, DENSE.min_r, DENSE.mass, ())
    err = lib.ppsim_grid_step(
        *(a.data_ptr() for a in t[:4]), *(0,) * 4, *(col.data_ptr(),) * 4,
        *(a.data_ptr() for a in (*out[:4], sp)), cuda.index, cap, R, C, 0, C, law,
        *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem, f32(geom.bin_size),
        *consts, f32(DENSE.dt), f32(DENSE.size), stream)
    torch.cuda.synchronize()
    assert err == 1
    cnt = torch.full((4, R, C), 7, dtype=torch.int32, device=cuda)
    plan = rebin_plan((cap, R, C))
    err = lib.ppsim_rebin_axes(
        *(a.data_ptr() for a in t), *(0,) * 10, *(col.data_ptr(),) * 10,
        *(a.data_ptr() for a in (*out, cnt)), cuda.index, cap, R, C, 0, C, geom.rows,
        geom.cols, EVAC, *plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem,
        f32(geom.bin_size), f32(1.0 / geom.bin_size), stream)
    torch.cuda.synchronize()
    assert err == 1
    for a in (*out, sp, cnt):
        assert bool((a == 7).all())
