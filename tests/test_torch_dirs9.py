"""Port parity of the rest of the 2D kernel family: the dirs9 rebin (counts,
K7, and shuffle, K8), the force-only kernel K6 behind ``accel_of``, and
``profiling.phase_times``, against the JAX package on identical numpy
inputs. On the CPU the kernel wrappers run their plain twins; the kernels
themselves are compared with the twins on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.initlib import init_particles as jinit_particles
from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.ops.pallas_grid import grid_force_pallas
from ppsim_tpu.ops.pallas_rebin import grid_rebin_pallas, rebin_counts_pallas

from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.ops import grid_ops as T
from ppsim_tpu_torch.ops.cuda_grid import grid_force_cuda, grid_force_plain
from ppsim_tpu_torch.ops.cuda_rebin import (
    grid_rebin_cuda, rebin_counts_cuda, rebin_shuffle_cuda,
)
from ppsim_tpu_torch.profiling import phase_times

from test_grid_ops import _stress_slab
from test_torch_grid_ops import STRESS, _assert_slab_equal, _drifted, _geoms, _to_torch

# tiny_grid_config with dirs9; evac 1 so that the 24-step run defers.
TINY = dict(num_parts=200, grid_bin_scale=3.0, grid_capacity=6, evac_capacity=1,
            rebin_every=4, grid_rebin_mode="dirs9")
# 8 x 8 bins (one row block), capacity 4: small enough that the TPU kernels'
# interpret-mode compiles stay within seconds.
SMALL = dict(num_parts=100, grid_bin_scale=3.0, grid_capacity=4, evac_capacity=2,
             rebin_every=4, grid_rebin_mode="dirs9")
# K6's twin (and the cuda engine's accel_of) against the TPU kernel: the TPU
# sums dr, then j, then dc (pallas_grid._accum_pairs), the twin DIRS order,
# then j, so the float32 sums differ in their last bits (measured up to 3e-6
# relative). The grid engine's accel_of takes the law in physics.py's form
# (sqrt and two divisions, as the JAX grid engine does) where the kernels
# take rsqrt: a few ulps more (measured 1.1e-5).
ACC_RTOL, ACC_ATOL = 1e-5, 1e-6
GRID_ACC_RTOL = 3e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mon(m):
    return [int(v) for v in m]


def _slab_case(case):
    """(JAX slab, JAX geometry, torch geometry, evac): a drifted packed slab
    (movers in all 9 directions) or the contention slab with 2 far movers."""
    if case == "drifted":
        jcfg = JConfig(**SMALL)
        jg, tg = _geoms(jcfg)
        return _drifted(jcfg, 4, 0.7), jg, tg, jcfg.evac_capacity
    jg, tg = J.SlabGeometry(**STRESS), T.SlabGeometry(**STRESS)
    return _stress_slab(jg, seed=0, far_movers=2)[0], jg, tg, 2


@pytest.mark.parametrize("case", ["drifted", "contention"])
def test_rebin_counts_and_grid_rebin_match_jax(case):
    """grid_ops.rebin_counts and grid_rebin against the JAX XLA twins: count
    planes equal, all five planes bitwise, monitors (deferred = rejected
    leavers before the shuffle) equal."""
    jslab, jg, tg, evac = _slab_case(case)
    ts = _to_torch(jslab)
    jcounts, jfar = J.rebin_counts(jslab, jg)
    tcounts, tfar = T.rebin_counts(ts, tg)
    assert tcounts.dtype == torch.int32
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int32))
    np.testing.assert_array_equal(tfar.numpy(), np.asarray(jfar))
    assert all(int(tcounts[d].sum()) > 0 for d in range(9))  # every direction
    jnew, jmon = jax.jit(lambda s: J.grid_rebin(s, jg, evac))(jslab)
    tnew, tmon = T.grid_rebin(ts, tg, evac)
    _assert_slab_equal(tnew, jnew)
    assert _mon(tmon) == _mon(jmon)
    assert int(tmon.deferred) > 0 and int(tmon.dropped) == (2 if case == "contention" else 0)
    assert int((tnew.pid != ts.pid).sum()) > 0


def test_dirs9_twins_match_pallas_interpret():
    """K7's and K8's plain twins (the wrappers on CPU tensors) against the
    TPU kernels in interpret mode on the contention slab: counts equal, all
    five planes bitwise (grid_rebin_pallas's slab is rebin_shuffle_pallas's
    output); and grid_rebin_cuda's monitors against grid_rebin_pallas's
    (deferred = live slots still pointing out after the shuffle)."""
    jslab, jg, tg, evac = _slab_case("contention")
    ts = _to_torch(jslab)
    before = (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches)
    jcounts = rebin_counts_pallas(jslab, jg, interpret=True)
    tcounts = rebin_counts_cuda(ts, tg)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int32))
    jnew, jmon = grid_rebin_pallas(jslab, jg, evac, interpret=True)
    tnew, cnt = rebin_shuffle_cuda(ts, tcounts, tg, evac)
    _assert_slab_equal(tnew, jnew)
    assert cnt.shape == (4, *tg.shape[1:]) and cnt.dtype == torch.int32
    gnew, tmon = grid_rebin_cuda(ts, tg, evac)
    _assert_slab_equal(gnew, jnew)
    assert _mon(tmon) == _mon(jmon)
    assert int(tmon.dropped) == 2 and int(tmon.deferred) > 0
    assert (rebin_counts_cuda.launches, rebin_shuffle_cuda.launches) == before
    pids = tnew.pid[tnew.pid >= 0]
    assert pids.numel() == int((ts.pid >= 0).sum()) == torch.unique(pids).numel()


def _force_slab(cfg):
    """Packed reference-init slab of ``cfg``, live particles drifted by up to
    0.45 bins so that close pairs interact (numpy, from a seed)."""
    from ppsim_tpu.initlib import init_particles_reference

    jg = J.SlabGeometry.for_config(cfg)
    pos, vel = init_particles_reference(cfg.num_parts, cfg.size, 42)
    slab, ovf = J.slab_from_particles(np.asarray(pos, np.float32),
                                      np.asarray(vel, np.float32), jg)
    assert int(ovf) == 0
    rng = np.random.default_rng(5)
    xl, yl = np.array(slab.xl), np.array(slab.yl)
    live = np.asarray(slab.pid) >= 0
    bs = jg.bin_size
    xl[live] += rng.uniform(-0.45 * bs, 0.45 * bs, live.sum()).astype(np.float32)
    yl[live] += rng.uniform(-0.45 * bs, 0.45 * bs, live.sum()).astype(np.float32)
    return jg, xl, yl


@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_force_twin_and_accel_of_match_pallas_interpret(law):
    """grid_force_plain (K6's twin, through the wrapper on CPU tensors) and
    both engines' accel_of against grid_force_pallas in interpret mode."""
    cfg = JConfig(**SMALL)
    if law == "lj":
        cfg = dataclasses.replace(cfg, force_law="lj", dt=1e-4)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    jg, xl_np, yl_np = _force_slab(cfg)
    xl, yl = torch.from_numpy(xl_np), torch.from_numpy(yl_np)
    want = grid_force_pallas(xl_np, yl_np, jg, cfg.cutoff, cfg.min_r, cfg.mass,
                             interpret=True, law=law, law_params=cfg.law_params)
    assert float(np.abs(np.asarray(want[0])).max()) > 1.0  # pairs interact
    tg = T.SlabGeometry(**dataclasses.asdict(jg))
    before = grid_force_cuda.launches
    got = {"twin": grid_force_cuda(xl, yl, tg, cfg.cutoff, cfg.min_r, cfg.mass,
                                   law, tcfg.law_params)}
    assert grid_force_cuda.launches == before
    for name in ("grid", "cuda"):
        eng = get_engine(name, tcfg, device="cpu")
        assert eng.geom == tg
        got[name] = eng.accel_of(xl, yl)
    for name, (ax, ay) in got.items():
        rtol = GRID_ACC_RTOL if name == "grid" else ACC_RTOL
        for a, w in ((ax, want[0]), (ay, want[1])):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol,
                                       atol=ACC_ATOL, err_msg=name)
    ref = grid_force_plain(xl, yl, tg, cfg.cutoff, cfg.min_r, cfg.mass, law,
                           tcfg.law_params)
    for a, b in zip(got["twin"], ref):
        assert torch.equal(a, b)


def _inputs(jcfg):
    jstate = jinit_particles(jcfg, seed=42, method="reference")
    pos, vel = (np.asarray(a) for a in jstate)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return jstate, tcfg, particle_state_from_numpy(pos, vel)


def test_grid_engine_dirs9_matches_jax_grid_engine():
    """24 steps (6 dirs9 rebins): positions within 1e-5 of the JAX grid
    engine with dirs9, monitors equal."""
    jcfg = JConfig(**TINY)
    jstate, tcfg, tstate = _inputs(jcfg)
    jr = jget_engine("grid", jcfg).run(jstate, nsteps=24)
    tr = get_engine("grid", tcfg, device="cpu").run(tstate, nsteps=24)
    diff = np.abs(tr.state.pos.numpy() - np.asarray(jr.state.pos)).max()
    assert diff <= 1e-5
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert int(tr.monitors.deferred) > 0


def test_cuda_engine_dirs9_matches_jax_pallas_engine():
    """The cuda engine (its wrappers' plain twins on the CPU) against the JAX
    pallas engine in interpret mode, 8 steps with dirs9: monitors equal."""
    jcfg = JConfig(**SMALL)
    jstate, tcfg, tstate = _inputs(jcfg)
    jr = jget_engine("pallas", jcfg).run(jstate, nsteps=8)
    tr = get_engine("cuda", tcfg, device="cpu").run(tstate, nsteps=8)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=1e-5)


def test_phase_times_keys_on_cpu():
    """phase_times on a CPU grid engine returns the four phases, each >= 0
    (a timing on a loaded CPU says nothing stronger); the instance is left
    with its own phases."""
    tcfg = config_from_dict(TINY)
    eng = get_engine("grid", tcfg, device="cpu")
    _, _, tstate = _inputs(JConfig(**TINY))
    pt = phase_times(eng, tstate, steps=2)
    assert set(pt) == {"step", "force+move", "rebin", "overhead"}
    assert all(v >= 0.0 for v in pt.values())
    assert "move_phase" not in vars(eng) and "rebin_of" not in vars(eng)


def test_phase_times_refuses_engine_without_seam():
    class NoSeam:
        name = "oracle"

    with pytest.raises(TypeError, match="phase seam"):
        phase_times(NoSeam(), None)


def test_cli_dirs9_check_passes_on_cpu(capsys):
    rc = main(["-n", "500", "-s", "42", "--check", "--engine", "cuda",
               "--device", "cpu", "--steps", "100", "--grid-rebin-mode", "dirs9"])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "for 500 particles." in printed
    assert "Correctness check: PASS" in printed


def test_cli_trace_writes_chrome_trace(capsys, tmp_path):
    rc = main(["-n", "100", "-s", "1", "--engine", "cuda", "--device", "cpu",
               "--steps", "2", "--rebin-every", "2", "--grid-rebin-mode",
               "dirs9", "--trace", str(tmp_path)])
    assert rc == 0 and "Simulation Time = " in capsys.readouterr().out
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
