"""Port parity end to end: the ``cuda`` engine (on a CPU device, so its
wrappers run the plain twins) and the plain ``grid`` engine against the JAX
``grid`` engine; the CLI; and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.harness import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(jcfg, seed=42):
    jstate = jinit_particles(jcfg, seed=seed, method="reference")
    pos, vel = (np.asarray(a) for a in jstate)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return jstate, tcfg, particle_state_from_numpy(pos, vel)


@pytest.fixture(scope="module")
def jax_grid_run():
    """The JAX grid engine's 24-step run at tiny_grid_config (the fixture's
    values, module-scoped so the JAX compile happens once)."""
    from ppsim_tpu.config import SimConfig

    jcfg = SimConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                     evac_capacity=2, rebin_every=4)
    jstate, tcfg, tstate = _inputs(jcfg)
    return tcfg, tstate, jget_engine("grid", jcfg).run(jstate, nsteps=24)


@pytest.mark.parametrize("engine", ["cuda", "grid"])
def test_engine_matches_jax_grid_engine(jax_grid_run, engine):
    """24 steps (6 rebins at cadence 4): final positions within 1e-5,
    monitors max_bin_count / dropped / deferred exact."""
    tcfg, tstate, jr = jax_grid_run
    tr = get_engine(engine, tcfg, device="cpu").run(tstate, nsteps=24)
    diff = np.abs(tr.state.pos.numpy() - np.asarray(jr.state.pos)).max()
    print(f"{engine} vs JAX grid: max |dpos| = {diff:.3e}")
    assert diff <= 1e-5
    np.testing.assert_allclose(tr.state.vel.numpy(), np.asarray(jr.state.vel),
                               rtol=1e-4, atol=1e-4)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(
        float(jr.monitors.max_speed), rel=1e-4)
    get_engine(engine, tcfg, device="cpu").check(tr)


def test_saved_frames_follow_reference_cadence(tiny_grid_config):
    """Frames after steps 1, 1+savefreq, ... like the JAX driver."""
    jstate, tcfg, tstate = _inputs(tiny_grid_config, seed=7)
    jr = jget_engine("grid", tiny_grid_config).run(jstate, nsteps=13, savefreq=4)
    tr = get_engine("cuda", tcfg, device="cpu").run(tstate, nsteps=13, savefreq=4)
    assert tr.frames.shape == np.asarray(jr.frames).shape == (4, 200, 2)
    np.testing.assert_allclose(tr.frames, np.asarray(jr.frames), atol=1e-5)


def test_pack_overflow_escalates_capacity(tiny_grid_config):
    """An initial packing above the auto capacity drops nothing for good: the
    engine raises capacity and re-runs (grid.py's drop-detected escalation)."""
    tcfg = config_from_dict(dataclasses.asdict(tiny_grid_config)).with_(
        grid_capacity=None)
    eng = get_engine("cuda", tcfg, device="cpu")
    eng.geom = dataclasses.replace(eng.geom, capacity=1)
    _, _, tstate = _inputs(tiny_grid_config)
    r = eng.run(tstate, nsteps=2)
    assert eng.capacity > 1
    eng.check(r)
    assert int(torch.unique(r.carry.slab.pid[r.carry.slab.pid >= 0]).numel()) == 200


def test_cuda_engine_refuses_lj(tiny_grid_config):
    """The kernels take the LJ law now (pair_coef.cuh); what the step still
    refuses is a law the kernels do not have."""
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, pair_args

    tcfg = config_from_dict(dataclasses.asdict(tiny_grid_config)).with_(force_law="lj")
    eng = get_engine("cuda", tcfg, device="cpu")
    assert pair_args("lj", tcfg.cutoff, tcfg.min_r, tcfg.mass, tcfg.law_params)[0] == 1
    slab = eng.init_carry(_inputs(tiny_grid_config)[2]).slab
    with pytest.raises(ValueError, match="repulsive"):
        grid_step_cuda(*slab[:4], eng.geom, tcfg.cutoff, tcfg.min_r, tcfg.mass,
                       tcfg.dt, tcfg.size, law="morse")


@pytest.fixture(scope="module")
def jax_grid_lj_run():
    """The JAX grid engine's 24-step 2D LJ run (dt 1e-4) at the tiny grid
    geometry, with its inputs."""
    from ppsim_tpu.config import SimConfig

    jcfg = SimConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                     evac_capacity=2, rebin_every=4, force_law="lj", dt=1e-4)
    jstate, tcfg, tstate = _inputs(jcfg)
    return tcfg, tstate, jget_engine("grid", jcfg).run(jstate, nsteps=24)


def test_cuda_engine_lj_matches_jax_grid_engine(jax_grid_lj_run):
    """K1's LJ law (its plain twin on the CPU) over 24 steps: positions
    within 1e-5 of the JAX grid engine, monitors exact."""
    tcfg, tstate, jr = jax_grid_lj_run
    tr = get_engine("cuda", tcfg, device="cpu").run(tstate, nsteps=24)
    diff = np.abs(tr.state.pos.numpy() - np.asarray(jr.state.pos)).max()
    assert diff <= 1e-5
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(
        float(jr.monitors.max_speed), rel=1e-4)


def test_get_engine_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU: with
    no device, get_engine builds on CUDA, and raises where there is none."""
    from ppsim_tpu_torch.config import SimConfig

    for name, cfg in (("cuda", SimConfig(num_parts=200)),
                      ("cuda3d", SimConfig(num_parts=500, ndim=3, density=7e-6))):
        if torch.cuda.is_available():
            assert get_engine(name, cfg).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                get_engine(name, cfg)


def test_cli_check_passes_on_cpu(capsys, tmp_path):
    out = str(tmp_path / "traj.txt")
    rc = main(["-n", "500", "-s", "42", "--check", "--engine", "cuda",
               "--device", "cpu", "--steps", "100", "-o", out])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "for 500 particles." in printed
    assert "Correctness check: PASS" in printed
    with open(out) as f:
        assert f.readline().split()[0] == "500"


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["-n", "100", "-s", "1", "--steps", "2", "--engine", "grid",
              "--device", "cuda"])


def test_package_never_imports_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ppsim_tpu'] = None\n"
        "import ppsim_tpu_torch, ppsim_tpu_torch.harness, ppsim_tpu_torch.convert\n"
        "import ppsim_tpu_torch.checker, ppsim_tpu_torch.native\n"
        "import ppsim_tpu_torch.ops.cuda_grid, ppsim_tpu_torch.ops.cuda_rebin\n"
        "import ppsim_tpu_torch.ops.grid3d_ops, ppsim_tpu_torch.ops.cuda_grid3\n"
        "import ppsim_tpu_torch.ops.cuda_rebin3, ppsim_tpu_torch.engines.grid3d\n"
        "import ppsim_tpu_torch.testing, ppsim_tpu_torch.initlib, ppsim_tpu_torch.io\n"
        "import ppsim_tpu_torch.profiling, ppsim_tpu_torch.roofline\n"
        "import ppsim_tpu_torch.ops.cuda_roofline\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ppsim_tpu' or m.startswith('ppsim_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
