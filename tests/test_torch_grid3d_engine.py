"""Port parity of the 3D engines end to end: ``grid3d`` and ``cuda3d`` (on a
CPU device, so its kernel wrappers run their plain twins) against the JAX
``grid3d`` engine; the initial-pack auto-raise and spill, the drop-detected
escalation, the 3D CLI and 3D trajectories."""

import dataclasses

import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.engines.grid3d import Grid3DEngine as JGrid3DEngine
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch import profiling
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import base as base_mod
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.base import Monitors, RunResult
from ppsim_tpu_torch.engines.grid3d import Grid3DEngine
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.io import read_trajectory, write_trajectory
from ppsim_tpu_torch.state import make_state

BASE3 = dict(ndim=3, density=7e-6, grid3_capacity=8, evac_capacity=2,
             rebin3_every=4)
LJ = dict(force_law="lj", dt=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(jcfg, seed=42):
    """One numpy initial state for both packages (the JAX fast init)."""
    jstate = jinit_particles(jcfg, seed=seed, method="fast")
    pos, vel = (np.asarray(a) for a in jstate)
    return jstate, config_from_dict(dataclasses.asdict(jcfg)), \
        particle_state_from_numpy(pos, vel)


@pytest.fixture(scope="module", params=["repulsive", "lj"])
def jax_grid3d_run(request):
    """The JAX grid3d engine's 24-step run (6 rebins at cadence 4) at the
    JAX package's BASE3 test config, with its inputs."""
    jcfg = JConfig(num_parts=400, **BASE3,
                   **(LJ if request.param == "lj" else {}))
    jstate, tcfg, tstate = _inputs(jcfg)
    return tcfg, tstate, jget_engine("grid3d", jcfg).run(jstate, nsteps=24)


@pytest.mark.parametrize("engine", ["cuda3d", "grid3d"])
def test_engine_matches_jax_grid3d_engine(jax_grid3d_run, engine):
    """Final positions within 1e-5, monitors max_bin_count / dropped /
    deferred exact, max speed to 1e-5."""
    tcfg, tstate, jr = jax_grid3d_run
    eng = get_engine(engine, tcfg, device="cpu")
    tr = eng.run(tstate, nsteps=24)
    assert tr.state.pos.shape == (400, 3)
    diff = np.abs(tr.state.pos.numpy() - np.asarray(jr.state.pos)).max()
    assert diff <= 1e-5
    np.testing.assert_allclose(tr.state.vel.numpy(), np.asarray(jr.state.vel),
                               rtol=1e-4, atol=1e-4)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(
        float(jr.monitors.max_speed), rel=1e-5)
    eng.check(tr)
    pids = tr.carry.slab.pid[tr.carry.slab.pid >= 0]
    assert torch.equal(torch.sort(pids).values, torch.arange(400, dtype=torch.int32))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_sharded_grid3d_matches_jax_grid3d_engine(jax_grid3d_run, impl, P):
    """The sharded engine (tests/test_torch_sharded3d_engine.py) against the
    same JAX grid3d runs, the JAX package's own contract for its sharded 3D
    engine (tests/test_3d_grid.py:274): sharded_grid3d on LocalMesh(P), impl
    cuda (the kernels' twins on the CPU) and plain; final positions within
    1e-5, monitors max_bin_count / dropped / deferred exact, max speed to
    1e-5, every pid in one slot."""
    tcfg, tstate, jr = jax_grid3d_run
    eng = get_engine("sharded_grid3d", tcfg, device="cpu", shards=P, impl=impl)
    tr = eng.run(tstate, nsteps=24)
    diff = np.abs(tr.state.pos.numpy() - np.asarray(jr.state.pos)).max()
    assert diff <= 1e-5
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(
        float(jr.monitors.max_speed), rel=1e-5)
    eng.check(tr)
    pids = eng.full_slab(tr.carry).pid
    assert torch.equal(torch.sort(pids[pids >= 0]).values,
                       torch.arange(400, dtype=torch.int32))


def test_auto_raise_matches_jax():
    """An under-capacity pack auto-raises to the measured packing (+1 slot
    for LJ) as the JAX engine does, and the raised engine's step equals one
    built at a roomy capacity (empty slots are inert)."""
    jcfg = JConfig(num_parts=500, **BASE3)
    _, tcfg, tstate = _inputs(jcfg)
    for law_kw in ({}, LJ):
        jlow = JGrid3DEngine(dataclasses.replace(jcfg, grid3_capacity=5, **law_kw))
        jlow.init_carry(_inputs(jcfg)[0])
        low = get_engine("cuda3d", tcfg.with_(grid3_capacity=5, **law_kw),
                         device="cpu")
        carry = low.init_carry(tstate)
        assert low.capacity == jlow.capacity > 5
    assert low.capacity == low._pack_capacity
    ref = get_engine("cuda3d", tcfg.with_(**LJ), device="cpu")
    a = low.final_state(low.step_plain(carry))
    b = ref.final_state(ref.step_plain(ref.init_carry(tstate)))
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-6)


def test_drop_detected_capacity_escalation(monkeypatch):
    """Auto-capacity 3D runs re-run one slot higher after a drop; hand-set
    capacities never retry (the base run is stubbed)."""
    calls = []

    def result(dropped):
        z = torch.zeros((), dtype=torch.int32)
        m = Monitors(z, z + dropped, torch.zeros(()), z)
        return RunResult(None, None, m)

    def fake_run(self, state, nsteps=None, savefreq=0, max_device_frame_bytes=None):
        calls.append(self.geom.capacity)
        return result(0 if self.geom.capacity >= calls[0] + 2 else 3)

    monkeypatch.setattr(base_mod.Engine, "run", fake_run)
    auto = Grid3DEngine(SimConfig(num_parts=500, ndim=3, density=7e-6),
                        device="cpu")
    start = auto.geom.capacity
    res = auto.run(None)
    assert calls == [start, start + 1, start + 2]
    assert int(res.monitors.migrate_dropped) == 0
    calls.clear()
    hand = Grid3DEngine(SimConfig(num_parts=500, ndim=3, density=7e-6,
                                  grid3_capacity=start), device="cpu")
    res = hand.run(None)
    assert calls == [start] and int(res.monitors.migrate_dropped) == 3


def _spill_cfg(**over):
    base = dict(num_parts=8, ndim=3, density=7e-6, grid3_capacity=2,
                rebin3_every=1, grid3_spill=True)
    base.update(over)
    return SimConfig(**base)


def _spill_state(face_particle=(0.0295, 0.015, 0.015)):
    """The JAX package's spill scenario: 8 particles on a 2x2x2 grid, bin
    (0,0,0) one past capacity 2, its overflow 0.0005 from the +x face."""
    pos = np.array([
        [0.005, 0.005, 0.005], [0.012, 0.012, 0.012], list(face_particle),
        [0.035, 0.005, 0.005], [0.005, 0.035, 0.005], [0.005, 0.005, 0.035],
        [0.035, 0.035, 0.005], [0.035, 0.035, 0.035]], np.float32)
    vel = 0.05 * np.arange(24, dtype=np.float32).reshape(8, 3) - 0.5
    return make_state(pos, vel)


def test_spill_keeps_capacity_and_matches_jax_and_roomy_engine():
    st = _spill_state()
    eng = get_engine("cuda3d", _spill_cfg(), device="cpu")
    carry = eng.init_carry(st)
    assert eng.capacity == 2 and eng._pack_spill
    jeng = JGrid3DEngine(JConfig(**dataclasses.asdict(_spill_cfg())))
    jcarry = jeng.init_carry(type(jinit_particles(JConfig(num_parts=8), 1))(
        *(np.asarray(t) for t in st)))
    np.testing.assert_array_equal(carry.slab.pid.numpy(), np.asarray(jcarry.slab.pid))
    assert jeng.capacity == 2 and jeng._pack_spill
    ref = get_engine("cuda3d", _spill_cfg(grid3_capacity=4), device="cpu")
    a = eng.final_state(eng.step_plain(carry))
    b = ref.final_state(ref.step_plain(ref.init_carry(st)))
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-6)
    # later packs (every timed repeat) reuse the spill and lose nothing
    again = eng.init_carry(st)
    assert torch.equal(eng.final_state(again).pos, st.pos)


@pytest.mark.parametrize("case", ["center", "hand", "off"])
def test_spill_falls_back_to_raise(case):
    """No face within the spill depth, a hand capacity under auto spill, or
    spill off: the pack raises capacity to the packing instead."""
    st = _spill_state((0.015, 0.015, 0.015)) if case == "center" else _spill_state()
    spill = {"center": True, "hand": None, "off": False}[case]
    eng = get_engine("grid3d", _spill_cfg(grid3_spill=spill), device="cpu")
    eng.init_carry(st)
    assert eng.capacity == 3 and not eng._pack_spill


def test_cli_3d_check_passes_on_cpu(capsys, tmp_path):
    out = str(tmp_path / "traj3.txt")
    rc = main(["-n", "500", "--ndim", "3", "--density", "7e-6", "-s", "42",
               "--check", "--device", "cpu", "--steps", "20", "-o", out])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "for 500 particles." in printed
    assert "Correctness check: PASS" in printed
    frames, size = read_trajectory(out)
    assert frames.shape == (2, 500, 3)
    assert size == pytest.approx(SimConfig(num_parts=500, ndim=3, density=7e-6).size,
                                 rel=1e-5)


def test_trajectory3_round_trip(tmp_path):
    frames = np.random.default_rng(0).uniform(0, 0.15, (3, 20, 3))
    path = str(tmp_path / "t.txt")
    write_trajectory(path, frames, 0.15)
    back, size = read_trajectory(path)
    assert back.shape == (3, 20, 3) and size == 0.15
    np.testing.assert_allclose(back, frames, rtol=1e-5)


def test_engine_folds_the_four_step_counters():
    """``read_device_counters`` folds K3's four counters (pairs in range,
    coefficient passes, distance tests, test passes) into ``Counters``; on
    the CPU a traced run counts the pairs only (the twin has no warps), so
    the tests and both warp counters stay 0."""
    cfg = SimConfig(num_parts=400, **BASE3, **LJ)
    eng = get_engine("cuda3d", cfg, device="cpu")
    eng.pair_counts += torch.tensor([5, 2, 70, 3])
    eng.read_device_counters()
    record = eng.counters.record()
    assert [record[k] for k in ("pair_hits", "coef_warp_passes", "pair_tests",
                                "test_warp_passes")] == [5, 2, 70, 3]
    eng.pair_counts.zero_()
    with profiling.tracing():
        eng.run(init_particles(cfg, seed=3, method="fast"), nsteps=2)
    c = eng.counters
    assert c.pair_hits >= 2 * 400
    assert (c.coef_warp_passes, c.pair_tests, c.test_warp_passes) == (0, 0, 0)
