"""The kernel wrappers of ppsim_tpu_torch (K1 fused step, K2 fused rebin, K3
3D fused step, K4 + K5 3D rebin, K6 force-only, K7 + K8 dirs9 rebin, the
roofline probes fma_chain and stream_add) and their build. This file imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU the ``cuda``-marked tests skip (a CUDA kernel has no CPU mode) and
the rest check that the wrappers run their plain twins on CPU tensors only.
On a card the marked tests compare each kernel with its plain twin.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import slab3_state_from_numpy, slab_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops import grid3d_ops, grid_ops
from ppsim_tpu_torch.ops.cuda_grid import (
    grid_force_cuda, grid_force_plain, grid_step_cuda, grid_step_plain,
)
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_cuda, rebin_axes_call_plain, rebin_counts_cuda, rebin_counts_plain,
    rebin_plan, rebin_shuffle_cuda, rebin_shuffle_plain, shuffle_plan,
)
from ppsim_tpu_torch.ops.cuda_roofline import (
    fma_chain_cuda, fma_chain_plain, stream_add_cuda, stream_add_plain,
)
from ppsim_tpu_torch.ops.cuda_rebin3 import (
    rebin3_inplane_cuda, rebin3_inplane_plain, rebin3_plan, rebin3_ypass_cuda,
    rebin3_ypass_plain,
)
from ppsim_tpu_torch.testing import (
    REBIN_EDGE_GEOMETRY, REBIN_EDGE_GEOMETRY3, STEP_SLAB_KINDS, STRESS_GEOMETRY,
    STRESS_GEOMETRY3, rebin_edge_slab, step_slab, stress_slab, stress_slab3,
)

# K1 and K6 against their plain twins: same summation order and rounding,
# but the repulsive rsqrtf may move the last bit of a pair term. K6's outputs
# are the sums themselves, where close pairs' terms (up to ~1e7 on these
# slabs) cancel: its absolute tolerance is 1e-6 of the largest |a|.
RTOL, ATOL = 1e-5, 1e-6
ACC_ATOL = 1e-6
# fma_chain against its twin: the kernel's FFMA rounds once where the twin
# rounds the product and the sum apart, up to half an ulp (2^-24 relative)
# a step; b >= 1 carries each step's error forward unchanged, so 16 steps on
# inputs in [0.5, 1) stay within 16 * 2^-24 ~ 1e-6, and all terms are
# positive (the sum over chains cancels nothing).
FMA_RTOL = 1e-5
TINY = SimConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                 evac_capacity=2, rebin_every=4)
# n = 262,144: 229 x 229 bins padded to 232 x 256, capacity 11.
PAD2 = SimConfig(num_parts=262_144)
# 3D: the JAX package's BASE3 test config, and n = 262,144 (41^3 bins padded
# to 41 x 48 x 128, auto capacity 10).
TINY3 = SimConfig(num_parts=500, ndim=3, density=7e-6, grid3_capacity=8,
                  evac_capacity=2, rebin3_every=4)
PAD3 = SimConfig(num_parts=262_144, ndim=3, density=7e-6)
LJ = dict(force_law="lj", dt=1e-4)
# The tiled step kernels' sensitive slabs (testing.step_slab): 41 x 41 bins
# padded to 48 x 128 at capacity 6 (2D); 5^3 bins padded to 5 x 8 x 128 at
# capacity 8, the box filling its last bins (3D).
TINY2 = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                  evac_capacity=2, rebin_every=4)
EDGE3 = TINY3.with_(num_parts=472)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _drifted_slab(cfg, frac, seed, device="cpu", bounce=False):
    """Packed reference-init slab, live particles drifted by up to ``frac``
    bins; with ``bounce``, a few speeds of several box lengths per step."""
    geom = grid_ops.SlabGeometry.for_config(cfg)
    st = init_particles(cfg, seed=42)
    slab, ovf = grid_ops.slab_from_particles(st.pos, st.vel, geom)
    assert int(ovf) == 0
    xl, yl, vx, vy, pid = (t.numpy().copy() for t in slab)
    rng = np.random.default_rng(seed)
    live = pid >= 0
    bs = geom.bin_size
    xl[live] += rng.uniform(-frac * bs, frac * bs, live.sum()).astype(np.float32)
    yl[live] += rng.uniform(-frac * bs, frac * bs, live.sum()).astype(np.float32)
    if bounce:
        for k, (s, r, c) in enumerate(np.argwhere(live)[:12]):
            vx[s, r, c] = (-1) ** k * 3000.0
            vy[s, r, c] = (-1) ** (k // 2) * (500.0 + 200.0 * k)
    return geom, slab_state_from_numpy(xl, yl, vx, vy, pid, device=device)


def _step_args(cfg, geom):
    return (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size)


def _drifted_slab3(cfg, frac, seed, device="cpu"):
    """Packed fast-init 3D slab, live particles drifted by up to ``frac``
    bins on each axis: at 0.2 pairs interact (closest near 0.6 cutoff, as in
    a run that passes the checker), at 0.8 movers cross every face."""
    geom = grid3d_ops.Geometry3S.for_config(cfg)
    st = init_particles(cfg, seed=42, method="fast")
    slab, ovf = grid3d_ops.slab3_from_particles(st.pos, st.vel, geom)
    assert int(ovf) == 0
    arrays = [t.numpy().copy() for t in slab]
    rng = np.random.default_rng(seed)
    live = arrays[6] >= 0
    for k, bs in enumerate((geom.bsx, geom.bsy, geom.bsz)):
        arrays[k][live] += rng.uniform(-frac * bs, frac * bs,
                                       live.sum()).astype(np.float32)
    return geom, slab3_state_from_numpy(*arrays, device=device)


def _step3_args(cfg, geom):
    return (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size,
            cfg.force_law, cfg.law_params)


def test_step_wrapper_runs_plain_twin_on_cpu_only():
    geom, slab = _drifted_slab(TINY, 0.45, 0)
    before = grid_step_cuda.launches
    got = grid_step_cuda(*slab[:4], *_step_args(TINY, geom))
    want = grid_step_plain(*slab[:4], *_step_args(TINY, geom))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert grid_step_cuda.launches == before  # nothing launched on the CPU
    meta = [torch.empty(geom.shape, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        grid_step_cuda(*meta, *_step_args(TINY, geom))


def test_rebin_wrapper_runs_plain_twin_on_cpu_only():
    g = STRESS_GEOMETRY
    slab = stress_slab(g, seed=1, far_movers=1)
    before = rebin_axes_call_cuda.launches
    got, gcnt = rebin_axes_call_cuda(slab, g, 2)
    want, wcnt = rebin_axes_call_plain(slab, g, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gcnt, wcnt) and gcnt.dtype == torch.int32
    assert rebin_axes_call_cuda.launches == before
    meta = grid_ops.SlabState(*(torch.empty(g.shape, device="meta") for _ in range(4)),
                              torch.empty(g.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rebin_axes_call_cuda(meta, g, 2)


def test_force_wrapper_runs_plain_twin_on_cpu_only():
    geom, slab = _drifted_slab(TINY, 0.45, 0)
    before = grid_force_cuda.launches
    got = grid_force_cuda(*slab[:2], *_step_args(TINY, geom)[:4])
    want = grid_force_plain(*slab[:2], *_step_args(TINY, geom)[:4])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert grid_force_cuda.launches == before
    meta = [torch.empty(geom.shape, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        grid_force_cuda(*meta, *_step_args(TINY, geom)[:4])


def test_dirs9_wrappers_run_plain_twins_on_cpu_only():
    g = STRESS_GEOMETRY
    slab = stress_slab(g, seed=1, far_movers=1)
    before = (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches)
    counts = rebin_counts_cuda(slab, g)
    assert torch.equal(counts, rebin_counts_plain(slab, g))
    assert counts.shape == (9, *g.shape[1:]) and counts.dtype == torch.int32
    out, cnt = rebin_shuffle_cuda(slab, counts, g, 2)
    want, wcnt = rebin_shuffle_plain(slab, counts, g, 2)
    for a, b in zip((*out, cnt), (*want, wcnt)):
        assert torch.equal(a, b)
    assert (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches) == before
    meta = grid_ops.SlabState(*(torch.empty(g.shape, device="meta") for _ in range(4)),
                              torch.empty(g.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rebin_counts_cuda(meta, g)


def test_step3_wrapper_runs_plain_twin_on_cpu_only():
    cfg = TINY3.with_(**LJ)
    geom, slab = _drifted_slab3(cfg, 0.2, 0)
    before = grid3_step_cuda.launches
    got = grid3_step_cuda(*slab[:6], *_step3_args(cfg, geom))
    want = grid3_step_plain(*slab[:6], *_step3_args(cfg, geom))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[6].shape == geom.shape[1:]
    assert grid3_step_cuda.launches == before
    meta = [torch.empty(geom.shape, device="meta") for _ in range(6)]
    with pytest.raises(ValueError, match="CUDA"):
        grid3_step_cuda(*meta, *_step3_args(cfg, geom))


def test_rebin3_wrappers_run_plain_twins_on_cpu_only():
    g = STRESS_GEOMETRY3
    slab = stress_slab3(g, seed=1, far_movers=1)
    before = (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches)
    mid, cnt = rebin3_inplane_cuda(slab, g, 2)
    want_mid, want_cnt = rebin3_inplane_plain(slab, g, 2)
    out, post = rebin3_ypass_cuda(mid, cnt, g, 2)
    want_out, want_post = rebin3_ypass_plain(mid, cnt, g, 2)
    for a, b in zip((*mid, cnt, *out, post),
                    (*want_mid, want_cnt, *want_out, want_post)):
        assert torch.equal(a, b)
    assert cnt.shape == (5, *g.shape[1:]) and cnt.dtype == torch.int32
    assert post.shape == (2, *g.shape[1:]) and post.dtype == torch.int32
    assert (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches) == before
    meta = grid3d_ops.Slab3State(
        *(torch.empty(g.shape, device="meta") for _ in range(6)),
        torch.empty(g.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rebin3_inplane_cuda(meta, g, 2)


def test_build_cache_is_keyed_by_source(tmp_path, monkeypatch):
    """build_shared compiles once per source content and command, and
    rebuilds when the source changes (the same path the kernels take)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.c"
    src.write_text("int ppsim_probe(void) { return 7; }\n")
    cmd = lambda out: ["g++", "-shared", "-fPIC", "-x", "c", str(src), "-o", out]  # noqa: E731
    first = _build.build_shared("probe", [str(src)], cmd)
    assert _build.build_shared("probe", [str(src)], cmd) == first
    src.write_text("int ppsim_probe(void) { return 8; }\n")
    second = _build.build_shared("probe", [str(src)], cmd)
    assert second != first
    assert ctypes.CDLL(second).ppsim_probe() == 8
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="building bad failed"):
        _build.build_shared(
            "bad", [str(bad)],
            lambda out: ["g++", "-shared", "-x", "c", str(bad), "-o", out])


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [False, True])
def test_step_kernel_matches_plain_on_card(cuda, bounce):
    geom, slab = _drifted_slab(TINY, 0.45, 2, device=cuda, bounce=bounce)
    before = grid_step_cuda.launches
    got = grid_step_cuda(*slab[:4], *_step_args(TINY, geom))
    assert grid_step_cuda.launches == before + 1
    want = grid_step_plain(*slab[:4], *_step_args(TINY, geom))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,far", [(0, 0), (1, 2), (2, 1)])
def test_rebin_kernel_bitwise_on_card(cuda, seed, far):
    g = STRESS_GEOMETRY
    slab = stress_slab(g, seed=seed, far_movers=far, device=cuda)
    before = rebin_axes_call_cuda.launches
    got, gcnt = rebin_axes_call_cuda(slab, g, 2)
    assert rebin_axes_call_cuda.launches == before + 1
    want, wcnt = rebin_axes_call_plain(slab, g, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gcnt, wcnt)


@pytest.mark.cuda
def test_rebin_kernel_bitwise_on_packed_slab(cuda):
    cfg = dataclasses.replace(TINY, num_parts=3000)
    geom, slab = _drifted_slab(cfg, 0.8, 3, device=cuda)
    got, gcnt = rebin_axes_call_cuda(slab, geom, cfg.evac_capacity)
    want, wcnt = rebin_axes_call_plain(slab, geom, cfg.evac_capacity)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gcnt, wcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("cfg,frac", [(TINY, 0.3), (PAD2, 0.2)],
                         ids=["tiny", "padded"])
def test_force_kernel_matches_plain_on_card(cuda, cfg, frac, law):
    cfg = cfg.with_(**LJ) if law == "lj" else cfg
    geom, slab = _drifted_slab(cfg, frac, 6, device=cuda)
    args = (*slab[:2], geom, cfg.cutoff, cfg.min_r, cfg.mass, law, cfg.law_params)
    before = grid_force_cuda.launches
    got = grid_force_cuda(*args)
    assert grid_force_cuda.launches == before + 1
    want = grid_force_plain(*args)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert scale > 1.0  # forces act
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ACC_ATOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiny", "padded", "contention", "edge", "ragged", "cap32"])
def test_dirs9_kernels_bitwise_on_card(cuda, case):
    """K7 and K8 against their plain twins, bitwise on the count stack, the
    five planes and the monitor stack: drifted packed slabs, the contention
    slab, and K8's strip-edge slabs (full and one-slot bins around every
    strip and segment edge of shuffle_plan; extents the strips and segments
    do not divide; capacity 32)."""
    if case == "contention":
        geom, evac = STRESS_GEOMETRY, 2
        slab = stress_slab(geom, seed=3, far_movers=2, device=cuda)
    elif case in ("edge", "ragged", "cap32"):
        geom = _fused_rebin_geometry("2d", case)
        evac = 3 if case == "cap32" else 2
        slab = rebin_edge_slab(geom, shuffle_plan(geom.shape), seed=7, device=cuda)
    else:
        cfg = dataclasses.replace(TINY, num_parts=3000) if case == "tiny" else PAD2
        evac = cfg.evac_capacity
        geom, slab = _drifted_slab(cfg, 0.8, 7, device=cuda)
    before = (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches)
    counts = rebin_counts_cuda(slab, geom)
    assert torch.equal(counts, rebin_counts_plain(slab, geom))
    out, cnt = rebin_shuffle_cuda(slab, counts, geom, evac)
    want, wcnt = rebin_shuffle_plain(slab, counts, geom, evac)
    for a, b in zip((*out, cnt), (*want, wcnt)):
        assert torch.equal(a, b)
    assert (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert int((out.pid != slab.pid).sum()) > 0
    if case == "contention":
        assert int(grid_ops.monitors_of_counts(cnt).dropped) == 2


@pytest.mark.cuda
def test_shuffle_entry_point_refuses_other_plans(cuda):
    """K8's entry point launches only a plan with shuffle_plan's arithmetic
    for the geometry: a strip, segment, block size, block count or shared
    size that disagrees with the rest returns cudaErrorInvalidValue (1) and
    writes nothing; shuffle_plan's own plan launches and equals the twin."""
    geom = _fused_rebin_geometry("2d", "edge")
    cap, R, C = geom.shape
    slab = rebin_edge_slab(geom, shuffle_plan(geom.shape), seed=1, device=cuda)
    counts = rebin_counts_cuda(slab, geom)
    out = grid_ops.SlabState(*(torch.full_like(t, 7) for t in slab))
    cnt = torch.full((4, R, C), 7, dtype=torch.int32, device=cuda)
    plan = shuffle_plan(geom.shape)
    good = (*plan.tile, plan.seg, plan.threads, plan.blocks, plan.smem)
    lib = _build.kernels()

    def launch(tile, seg, threads, blocks, smem):
        err = lib.ppsim_rebin_shuffle(
            *(t.data_ptr() for t in (*slab, counts)), *(0,) * 12,
            *(t.data_ptr() for t in (*out, cnt)), cuda.index, cap, R,
            C, 0, geom.rows, geom.cols, 2, tile, seg, threads, blocks, smem,
            grid_ops.f32(geom.bin_size), grid_ops.f32(1.0 / geom.bin_size),
            torch.cuda.current_stream(cuda).cuda_stream)
        torch.cuda.synchronize()
        return err

    t, seg, threads, blocks, smem = good
    for bad in ((16, seg, threads, blocks, smem), (t, seg // 2, threads, blocks, smem),
                (t, seg, 128, blocks, smem), (t, seg, threads, blocks + 1, smem),
                (t, seg, threads, blocks, smem + 16)):
        assert launch(*bad) == 1, bad
    for a in (*out, cnt):
        assert bool((a == 7).all())
    assert launch(*good) == 0
    want, wcnt = rebin_shuffle_plain(slab, counts, geom, 2)
    for a, b in zip((*out, cnt), (*want, wcnt)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["axes", "dirs9"])
def test_cuda_engine_matches_grid_engine_on_card(cuda, mode):
    cfg = TINY.with_(grid_rebin_mode=mode)
    st = init_particles(cfg, seed=42)
    a = get_engine("cuda", cfg, device=cuda).run(st, nsteps=24)
    b = get_engine("grid", cfg, device=cuda).run(st, nsteps=24)
    torch.testing.assert_close(a.state.pos, b.state.pos, rtol=0, atol=1e-5)
    assert int(a.monitors.max_bin_count) == int(b.monitors.max_bin_count)
    assert int(a.monitors.migrate_dropped) == int(b.monitors.migrate_dropped) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("cfg", [TINY3, PAD3], ids=["tiny", "padded"])
def test_step3_kernel_matches_plain_on_card(cuda, cfg, law):
    cfg = cfg.with_(**LJ) if law == "lj" else cfg
    geom, slab = _drifted_slab3(cfg, 0.2, 4, device=cuda)
    args = _step3_args(cfg, geom)
    before = grid3_step_cuda.launches
    got = grid3_step_cuda(*slab[:6], *args)
    assert grid3_step_cuda.launches == before + 1
    want = grid3_step_plain(*slab[:6], *args)
    assert float((want[3] - slab.vx).abs().max()) > 0  # forces act
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiny", "padded", "contention"])
def test_rebin3_kernels_bitwise_on_card(cuda, case):
    if case == "contention":
        geom, evac = STRESS_GEOMETRY3, 2
        slab = stress_slab3(geom, seed=3, far_movers=2, device=cuda)
    else:
        cfg = TINY3 if case == "tiny" else PAD3
        evac = cfg.evac_capacity
        geom, slab = _drifted_slab3(cfg, 0.8, 5, device=cuda)
    before = (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches)
    mid, cnt = rebin3_inplane_cuda(slab, geom, evac)
    want_mid, want_cnt = rebin3_inplane_plain(slab, geom, evac)
    for a, b in zip((*mid, cnt), (*want_mid, want_cnt)):
        assert torch.equal(a, b)
    out, post = rebin3_ypass_cuda(mid, cnt, geom, evac)
    want_out, want_post = rebin3_ypass_plain(mid, cnt, geom, evac)
    for a, b in zip((*out, post), (*want_out, want_post)):
        assert torch.equal(a, b)
    assert (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert int((out.pid != slab.pid).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_cuda3d_engine_matches_grid3d_engine_on_card(cuda, law):
    cfg = TINY3.with_(**LJ) if law == "lj" else TINY3
    st = init_particles(cfg, seed=42, method="fast")
    a = get_engine("cuda3d", cfg, device=cuda).run(st, nsteps=24)
    b = get_engine("grid3d", cfg, device=cuda).run(st, nsteps=24)
    torch.testing.assert_close(a.state.pos, b.state.pos, rtol=0, atol=1e-5)
    assert int(a.monitors.max_bin_count) == int(b.monitors.max_bin_count)
    assert int(a.monitors.migrate_dropped) == int(b.monitors.migrate_dropped) == 0


def _step_kernels_match(cfg, geom, slab):
    """K1 and K6 (2D) or K3 (3D) against their plain twins on ``slab``,
    each launched exactly once."""
    law = cfg.force_law
    if cfg.ndim == 3:
        args = _step3_args(cfg, geom)
        before = grid3_step_cuda.launches
        got = grid3_step_cuda(*slab[:6], *args)
        assert grid3_step_cuda.launches == before + 1
        want = grid3_step_plain(*slab[:6], *args)
        assert float((want[3] - slab.vx).abs().max()) > 0  # forces act
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        return
    args = _step_args(cfg, geom) + (law, cfg.law_params)
    before = (grid_step_cuda.launches, grid_force_cuda.launches)
    got = grid_step_cuda(*slab[:4], *args)
    for g, w in zip(got, grid_step_plain(*slab[:4], *args)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    fargs = (geom, cfg.cutoff, cfg.min_r, cfg.mass, law, cfg.law_params)
    acc = grid_force_cuda(*slab[:2], *fargs)
    want = grid_force_plain(*slab[:2], *fargs)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert scale > 1.0  # forces act
    for g, w in zip(acc, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ACC_ATOL * scale)
    assert (grid_step_cuda.launches, grid_force_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("kind", STEP_SLAB_KINDS)
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_step_kernels_on_sensitive_slabs_on_card(cuda, dim, kind, law):
    """K1, K6 and K3 on slabs with holes after rebins, a bin at capacity,
    and particles in the edge bins beside the padding."""
    cfg = TINY2 if dim == "2d" else EDGE3
    cfg = cfg.with_(**LJ) if law == "lj" else cfg
    geom, slab = step_slab(cfg, kind, device=cuda)
    _step_kernels_match(cfg, geom, slab)


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_step_kernels_on_ragged_geometry_on_card(cuda, dim, law):
    """Array extents that the tiles and segments do not divide: 41 x 100
    (strips of 64 columns, segments of 8 rows) and 5 x 7 x 21 (4 x 16 tiles,
    one segment of all 5 slabs)."""
    cfg = TINY2 if dim == "2d" else EDGE3
    cfg = cfg.with_(**LJ) if law == "lj" else cfg
    rng = np.random.default_rng(11)
    st = init_particles(cfg, seed=42, method="fast" if dim == "3d" else "reference")
    if dim == "2d":
        geom = dataclasses.replace(grid_ops.SlabGeometry.for_config(cfg),
                                   rows_pad=41, cols_pad=100)
        slab, ovf = grid_ops.slab_from_particles(st.pos, st.vel, geom)
        sides, frac = (geom.bin_size,) * 2, 0.3
        make = slab_state_from_numpy
    else:
        geom = dataclasses.replace(grid3d_ops.Geometry3S.for_config(cfg),
                                   xs_pad=7, zs_pad=21)
        slab, ovf = grid3d_ops.slab3_from_particles(st.pos, st.vel, geom)
        sides, frac = (geom.bsx, geom.bsy, geom.bsz), 0.2
        make = slab3_state_from_numpy
    assert int(ovf) == 0
    arrays = [t.numpy().copy() for t in slab]
    live = arrays[-1] >= 0
    for k, bs in enumerate(sides):
        arrays[k][live] += rng.uniform(-frac * bs, frac * bs,
                                       live.sum()).astype(np.float32)
    _step_kernels_match(cfg, geom, make(*arrays, device=cuda))


def _fused_rebin_geometry(dim, case):
    """The edge geometries of testing.rebin_edge_slab (several strips and
    segments, padding included); for ``ragged`` extents the strips do not
    divide (2D 21 x 150 bins: four strips of 32 columns and one of 22; 3D
    3 x 19 x 70: 32, 32 and 6 z-bins); ``cap32`` those at capacity 32
    (strips of 16: the last of 6 bins)."""
    geom = REBIN_EDGE_GEOMETRY if dim == "2d" else REBIN_EDGE_GEOMETRY3
    if case != "edge":
        geom = (dataclasses.replace(geom, rows_pad=21, cols_pad=150) if dim == "2d"
                else dataclasses.replace(geom, xs_pad=19, zs_pad=70))
    if case == "cap32":
        geom = dataclasses.replace(geom, capacity=32)
    return geom


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge", "ragged", "cap32"])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_fused_rebin_kernels_bitwise_on_edge_slabs_on_card(cuda, dim, case):
    """K2 (2D) and K4 then K5 (3D) against their plain twins on a slab with
    full bins and movers on the strips' halo bins, bitwise on every plane
    and count plane; one launch each, and the input slab left untouched."""
    geom = _fused_rebin_geometry(dim, case)
    evac = 3 if case == "cap32" else 2
    if dim == "2d":
        slab = rebin_edge_slab(geom, rebin_plan(geom.shape), seed=5, device=cuda)
        keep = [t.clone() for t in slab]
        before = rebin_axes_call_cuda.launches
        got = rebin_axes_call_cuda(slab, geom, evac)
        assert rebin_axes_call_cuda.launches == before + 1
        want = rebin_axes_call_plain(slab, geom, evac)
        out = got[0]
    else:
        slab = rebin_edge_slab(geom, rebin3_plan(geom.shape), seed=5, device=cuda)
        keep = [t.clone() for t in slab]
        before = (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches)
        mid, cnt = rebin3_inplane_cuda(slab, geom, evac)
        wmid, wcnt = rebin3_inplane_plain(slab, geom, evac)
        for a, b in zip((*mid, cnt), (*wmid, wcnt)):
            assert torch.equal(a, b)
        got = rebin3_ypass_cuda(mid, cnt, geom, evac)
        want = rebin3_ypass_plain(mid, cnt, geom, evac)
        assert (rebin3_inplane_cuda.launches, rebin3_ypass_cuda.launches) == (
            before[0] + 1, before[1] + 1)
        out = got[0]
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    for a, b in zip(slab, keep):
        assert torch.equal(a, b)
    assert int((out.pid != slab.pid).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 2, 4, 8])
def test_fma_chain_kernel_matches_twin_on_card(cuda, chains):
    """fma_chain on a seeded input in [0.5, 1) at 16 steps, finite and
    within FMA_RTOL of its twin; one launch."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0.5, 1.0, (1000, 37)).astype(np.float32)).to(cuda)
    before = fma_chain_cuda.launches
    got = fma_chain_cuda(x, 16, chains)
    assert fma_chain_cuda.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, fma_chain_plain(x, 16, chains), rtol=FMA_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 4099, 1 << 20])
def test_stream_add_kernel_bitwise_on_card(cuda, n):
    """stream_add equals x + 1 bitwise, on lengths that are not a multiple
    of 4 too; a base pointer off 16 bytes is refused."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    x = x.to(cuda)
    out = torch.empty_like(x)
    assert stream_add_cuda(x, out=out) is out
    assert torch.equal(out, stream_add_plain(x))
    if n > 1:
        with pytest.raises(ValueError, match="16-byte"):
            stream_add_cuda(x[1:])
