"""The kernel wrappers of ppsim_tpu_torch (K1 fused step, K2 rebin) and their
build. This file imports no JAX, so it also runs on a GPU host without it:

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
from ppsim_tpu_torch.convert import slab_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops import grid_ops
from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
from ppsim_tpu_torch.ops.cuda_rebin import rebin_axes_call_cuda, rebin_axes_call_plain
from ppsim_tpu_torch.testing import STRESS_GEOMETRY, stress_slab

# K1 against its plain twin: same summation order, but rsqrtf and FMA
# contraction may move the last bits of the pair sums.
RTOL, ATOL = 1e-5, 1e-6
TINY = SimConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                 evac_capacity=2, rebin_every=4)


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
def test_cuda_engine_matches_grid_engine_on_card(cuda):
    st = init_particles(TINY, seed=42)
    a = get_engine("cuda", TINY, device=cuda).run(st, nsteps=24)
    b = get_engine("grid", TINY, device=cuda).run(st, nsteps=24)
    torch.testing.assert_close(a.state.pos, b.state.pos, rtol=0, atol=1e-5)
    assert int(a.monitors.max_bin_count) == int(b.monitors.max_bin_count)
    assert int(a.monitors.migrate_dropped) == int(b.monitors.migrate_dropped) == 0
