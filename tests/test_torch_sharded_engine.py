"""The port's ``sharded_grid`` engine on the in-process ``LocalMesh``:
against the JAX package's ``sharded_grid`` on two CPU devices, against the
port's single-device engines at P = 1, 2 and 4 (bitwise), the CLI's
``--shards``, the default device, and the port's independence from JAX."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ppsim_tpu.engines.sharded_grid import ShardedGridEngine as JShardedGridEngine
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.initlib import init_particles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX package's own bound for its sharded engine against its grid engine
# (tests/test_sharded_grid.py): the shard kernels sum the pair forces in
# another order than the plain ops.
ATOL = 2e-6
# 41 x 41 bins, capacity 6, cadence 4: dense enough that particles cross the
# shard boundaries within a few rebins.
DENSE = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                  evac_capacity=2, rebin_every=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["axes", "dirs9"])
def jax_sharded_run(request):
    """The JAX sharded_grid engine (its plain-op impl, "xla") on two CPU
    devices: tiny_grid_config's values, 16 steps (4 rebins)."""
    from ppsim_tpu.config import SimConfig as JConfig

    jcfg = JConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                   evac_capacity=2, rebin_every=4, grid_rebin_mode=request.param)
    jstate = jinit_particles(jcfg, seed=42, method="reference")
    jeng = JShardedGridEngine(jcfg, devices=jax.devices()[:2], impl="xla")
    jr = jeng.run(jstate, nsteps=16)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return (tcfg, particle_state_from_numpy(*(np.asarray(a) for a in jstate)),
            dataclasses.asdict(jeng.geom), jr)


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_sharded_grid_tracks_jax_sharded_grid(jax_sharded_run, impl):
    """The port's sharded_grid (impl cuda: the kernels' twins on the CPU;
    impl plain: the grid engine's ops) on LocalMesh(2) against the JAX
    sharded_grid on two devices, both rebin modes: positions within 2e-6,
    monitors equal."""
    tcfg, tstate, jgeom, jr = jax_sharded_run
    eng = get_engine("sharded_grid", tcfg, device="cpu", shards=2, impl=impl)
    assert dataclasses.asdict(eng.geom) == jgeom  # rows padded to 2 strips of 8
    tr = eng.run(tstate, nsteps=16)
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos), atol=ATOL)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(float(jr.monitors.max_speed),
                                                         rel=1e-5)
    eng.check(tr)


def _shard_of_pids(engine, carry):
    """Each live pid's shard, as a dict."""
    return {int(p): d for d, s in zip(engine.mesh.shards, carry.slab)
            for p in s.pid[s.pid >= 0].tolist()}


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("mode", ["axes", "dirs9"])
def test_sharded_grid_equals_single_device_engines(mode, P):
    """sharded_grid on LocalMesh(P) equals the single-device engines bitwise
    through rebins with cross-shard migration: impl plain the grid engine,
    impl cuda the cuda engine (both on the CPU); monitors equal (dirs9's
    deferred has two definitions, note in cuda_rebin: the cuda engine's is
    the sharded engine's)."""
    cfg = DENSE.with_(grid_rebin_mode=mode)
    state = init_particles(cfg, seed=42)
    for impl, single in (("plain", "grid"), ("cuda", "cuda")):
        ref = get_engine(single, cfg, device="cpu").run(state, nsteps=24)
        eng = get_engine("sharded_grid", cfg, device="cpu", shards=P, impl=impl)
        res = eng.run(state, nsteps=24)
        assert torch.equal(res.state.pos, ref.state.pos), impl
        assert torch.equal(res.state.vel, ref.state.vel), impl
        fields = ("max_bin_count", "migrate_dropped", "max_speed")
        if mode == "axes" or impl == "cuda":
            fields += ("deferred",)
        for f in fields:
            assert getattr(res.monitors, f) == getattr(ref.monitors, f), (impl, f)
        eng.check(res)
        if P > 1:
            before = _shard_of_pids(eng, eng.init_carry(state))
            after = _shard_of_pids(eng, res.carry)
            assert sorted(after) == list(range(cfg.num_parts))
            assert sum(before[p] != after[p] for p in after) > 0  # migration


def test_sharded_grid_saved_run_equals_grid():
    """A saved run (savefreq 5, off the rebin cadence) on LocalMesh(4): the
    frames equal the single-device cuda engine's."""
    state = init_particles(DENSE, seed=7)
    ref = get_engine("cuda", DENSE, device="cpu").run(state, nsteps=17, savefreq=5)
    res = get_engine("sharded_grid", DENSE, device="cpu", shards=4).run(
        state, nsteps=17, savefreq=5)
    assert res.frames.shape == ref.frames.shape == (4, DENSE.num_parts, 2)
    np.testing.assert_array_equal(res.frames, ref.frames)


def test_sharded_grid_has_no_capacity_escalation():
    """As in the JAX engine, an under-capacity run is not re-run at a higher
    capacity: it fails at check()."""
    cfg = DENSE.with_(grid_capacity=None)
    eng = get_engine("sharded_grid", cfg, device="cpu", shards=2)
    eng.geom = dataclasses.replace(eng.geom, capacity=1)
    res = eng.run(init_particles(cfg, seed=42), nsteps=1)
    assert eng.capacity == 1
    with pytest.raises(RuntimeError, match="overflow|dropped"):
        eng.check(res)


def test_phase_times_sharded_seam():
    """profiling.phase_times reaches the sharded engine through its
    _phase_disable seam and leaves it unset."""
    from ppsim_tpu_torch.profiling import phase_times

    cfg = SimConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                    evac_capacity=2, rebin_every=4)
    eng = get_engine("sharded_grid", cfg, device="cpu", shards=2)
    pt = phase_times(eng, init_particles(cfg, seed=1), steps=4)
    assert set(pt) == {"step", "force+move", "rebin", "overhead"}
    assert eng._phase_disable is None and "move_phase" not in vars(eng)


def test_cli_sharded_grid_on_cpu(capsys):
    rc = main(["-n", "500", "-s", "42", "--check", "--engine", "sharded_grid",
               "--shards", "2", "--device", "cpu", "--steps", "40"])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "Correctness check: PASS" in printed


def test_cli_refuses_shards_for_other_engines():
    with pytest.raises(SystemExit):
        main(["-n", "100", "--engine", "cuda", "--shards", "2", "--device", "cpu"])


def test_sharded_grid_defaults_to_the_card():
    """With no device the engine builds on CUDA, and raises where there is
    none; impl is checked."""
    cfg = SimConfig(num_parts=200)
    if torch.cuda.is_available():
        assert get_engine("sharded_grid", cfg, shards=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            get_engine("sharded_grid", cfg, shards=2)
    with pytest.raises(ValueError, match="impl"):
        get_engine("sharded_grid", cfg, device="cpu", impl="xla")


def test_sharded_modules_and_chip_smoke_never_import_jax():
    """The sharded engine, its mesh and chip_smoke.py import nothing of JAX
    or the JAX package, at import time or inside any function."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ppsim_tpu'] = None\n"
        "import ppsim_tpu_torch.engines.sharded_grid, ppsim_tpu_torch.engines.mesh\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(ROOT, "ppsim_tpu_torch"))
        for f in fs if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "ppsim_tpu"), (path, name)
