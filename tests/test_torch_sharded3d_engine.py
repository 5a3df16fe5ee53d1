"""The port's ``sharded_grid3d`` engine on the in-process ``LocalMesh``:
bitwise against the port's single-device 3D engines at P = 1, 2 and 4 with
cross-shard migration, against the JAX package's ``sharded_grid3d`` on two
CPU devices, the escalation that heals itself, the ``phase_times`` seam, the
CLI's ``--shards`` with ``--ndim 3``, and the default device. (Against the
JAX ``grid3d`` engine it is held in tests/test_torch_grid3d_engine.py,
beside that file's JAX runs, which it reuses.)"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines.sharded_grid3d import ShardedGrid3DEngine as JShardedGrid3DEngine
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.base import Monitors, RunResult
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.initlib import init_particles

# The JAX package's 3D test config (5 x 5 x 5 bins, capacity 8, cadence 4);
# 12 steps = 3 rebins, in which particles cross the strip boundaries.
BASE3 = dict(ndim=3, density=7e-6, grid3_capacity=8, evac_capacity=2,
             rebin3_every=4)
CFG3 = SimConfig(num_parts=400, **BASE3)
STEPS = 12
# The JAX package's own bound for its sharded 3D engine against its grid3d
# engine (tests/test_3d_grid.py): the sums run in another order.
ATOL = 2e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single_runs():
    """The port's single-device runs of CFG3 (plain grid3d, and cuda3d
    whose wrappers run their twins on the CPU), keyed by engine name (on
    one torch thread: a module fixture is set up before the per-test one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = init_particles(CFG3, seed=42, method="fast")
        runs = {name: get_engine(name, CFG3, device="cpu").run(state, nsteps=STEPS)
                for name in ("grid3d", "cuda3d")}
    finally:
        torch.set_num_threads(threads)
    return state, runs


def _shard_of_pids(engine, carry):
    """Each live pid's shard, as a dict."""
    return {int(p): d for d, s in zip(engine.mesh.shards, carry.slab)
            for p in s.pid[s.pid >= 0].tolist()}


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sharded_grid3d_equals_single_device_engines(single_runs, P):
    """sharded_grid3d on LocalMesh(P) equals the single-device engines
    bitwise through rebins with cross-shard migration (impl plain the grid3d
    engine, impl cuda the cuda3d engine, both on the CPU); monitors equal;
    every pid in one slot."""
    state, refs = single_runs
    for impl, single in (("plain", "grid3d"), ("cuda", "cuda3d")):
        ref = refs[single]
        eng = get_engine("sharded_grid3d", CFG3, device="cpu", shards=P, impl=impl)
        assert eng.ys_local == max(2, -(-eng.geom.ys // P))
        assert eng.geom.ys_pad == P * eng.ys_local
        res = eng.run(state, nsteps=STEPS)
        assert torch.equal(res.state.pos, ref.state.pos), impl
        assert torch.equal(res.state.vel, ref.state.vel), impl
        for f in Monitors._fields:
            assert getattr(res.monitors, f) == getattr(ref.monitors, f), (impl, f)
        eng.check(res)
        after = _shard_of_pids(eng, res.carry)
        assert sorted(after) == list(range(CFG3.num_parts))
        if P > 1:
            before = _shard_of_pids(eng, eng.init_carry(state))
            assert sum(before[p] != after[p] for p in after) > 0  # migration


@pytest.fixture(scope="module")
def jax_sharded3d_run():
    """The JAX sharded_grid3d engine (its plain-op impl, "xla") on two CPU
    devices, CFG3's values, 12 steps (3 rebins; ~18 s of compiles)."""
    jcfg = JConfig(num_parts=400, **BASE3)
    jstate = jinit_particles(jcfg, seed=42, method="fast")
    jeng = JShardedGrid3DEngine(jcfg, devices=jax.devices()[:2], impl="xla")
    jr = jeng.run(jstate, nsteps=STEPS)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return (tcfg, particle_state_from_numpy(*(np.asarray(a) for a in jstate)),
            dataclasses.asdict(jeng.geom), jr)


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_sharded_grid3d_tracks_jax_sharded_grid3d(jax_sharded3d_run, impl):
    """The port's sharded_grid3d on LocalMesh(2) against the JAX
    sharded_grid3d on two devices: the same padded geometry, positions
    within 2e-6, monitors equal."""
    tcfg, tstate, jgeom, jr = jax_sharded3d_run
    eng = get_engine("sharded_grid3d", tcfg, device="cpu", shards=2, impl=impl)
    assert dataclasses.asdict(eng.geom) == jgeom  # y padded to 2 strips of 3
    tr = eng.run(tstate, nsteps=STEPS)
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos), atol=ATOL)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(float(jr.monitors.max_speed),
                                                         rel=1e-5)
    eng.check(tr)


def test_sharded_grid3d_escalation_self_heals():
    """As in the JAX engine (tests/test_3d_grid.py:608): an auto-capacity
    run that dropped particles raises capacity one slot and re-runs; the
    strips stay as they were, and the escalated run's physics is unchanged
    (capacity is headroom)."""
    cfg = SimConfig(num_parts=500, ndim=3, density=7e-6, evac_capacity=2,
                    rebin3_every=4)
    state = init_particles(cfg, seed=42, method="fast")
    eng = get_engine("sharded_grid3d", cfg, device="cpu", shards=2)
    r1 = eng.run(state, nsteps=2)
    cap1, strips = eng.geom.capacity, (eng.ys_local, eng.geom.ys_pad)
    z = torch.zeros((), dtype=torch.int32)
    fake = RunResult(None, None, Monitors(z, z + 3, torch.zeros(()), z))
    assert eng.maybe_escalate_after_drop(fake)  # auto capacity: heals now
    assert eng.geom.capacity == cap1 + 1
    assert (eng.ys_local, eng.geom.ys_pad) == strips
    r2 = eng.run(state, nsteps=2)
    assert r2.carry.slab[0].xl.shape[0] == cap1 + 1
    np.testing.assert_allclose(r1.state.pos.numpy(), r2.state.pos.numpy(), atol=1e-7)
    pids = torch.cat([s.pid[s.pid >= 0] for s in r2.carry.slab])
    assert torch.equal(torch.sort(pids).values, torch.arange(cfg.num_parts, dtype=torch.int32))
    # a hand capacity never retries
    hand = get_engine("sharded_grid3d", cfg.with_(grid3_capacity=cap1), device="cpu",
                      shards=2)
    assert not hand.maybe_escalate_after_drop(fake)


def test_phase_times_sharded3d_seam(monkeypatch):
    """profiling.phase_times reaches the 3D sharded engine through its
    _phase_disable seam (the full step, then without the move, then without
    the rebin) and leaves it unset; each variant skips its phase. The timer
    is stubbed: on the CPU its values say nothing, and the plain twins make
    a real measurement cost ~40 s here."""
    from ppsim_tpu_torch import profiling

    eng = get_engine("sharded_grid3d", SimConfig(num_parts=200, **BASE3), device="cpu",
                     shards=2)
    seen = []

    def fake_timeit(step_fn, carry, steps_a, steps_b, device):
        seen.append(eng._phase_disable)
        return {None: 3.0, "move": 1.0, "rebin": 2.5}[eng._phase_disable]

    monkeypatch.setattr(profiling, "timeit_steps", fake_timeit)
    state = init_particles(eng.config, seed=1, method="fast")
    pt = profiling.phase_times(eng, state, steps=4)
    assert seen == [None, "move", "rebin"]
    assert pt == {"step": 3.0, "force+move": 2.0, "rebin": 0.5, "overhead": 0.5}
    assert eng._phase_disable is None and "move_phase" not in vars(eng)
    carry = eng.init_carry(state)
    eng._phase_disable = "move"
    out, speed = eng.move_phase(carry.slab)
    assert out is carry.slab and float(speed) == 0.0
    eng._phase_disable = "rebin"
    out, mon = eng.rebin_of(carry.slab)
    assert out is carry.slab and [int(m) for m in mon] == [0, 0, 0]


def test_cli_sharded_grid3d_on_cpu(capsys):
    rc = main(["-n", "300", "--ndim", "3", "--density", "7e-6", "-s", "42", "--check",
               "--engine", "sharded_grid3d", "--shards", "2", "--device", "cpu",
               "--steps", "12"])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "Correctness check: PASS" in printed


@pytest.mark.parametrize("engine", ["grid", "grid3d", "cuda3d"])
def test_cli_refuses_shards_for_unsharded_engines(engine):
    ndim = "3" if "3d" in engine else "2"
    with pytest.raises(SystemExit):
        main(["-n", "100", "--ndim", ndim, "--engine", engine, "--shards", "2",
              "--device", "cpu"])


def test_sharded_grid3d_defaults_to_the_card():
    """With no device the engine builds on CUDA, and raises where there is
    none; impl is checked."""
    cfg = SimConfig(num_parts=200, **BASE3)
    if torch.cuda.is_available():
        assert get_engine("sharded_grid3d", cfg, shards=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            get_engine("sharded_grid3d", cfg, shards=2)
    with pytest.raises(ValueError, match="impl"):
        get_engine("sharded_grid3d", cfg, device="cpu", impl="xla")
