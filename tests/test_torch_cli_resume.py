"""The CLI's checkpoint flags (``--checkpoint-out``, ``--resume``) and
repack flags, ``Engine.step_state`` against the JAX package's, and the
native binned engine ``native_run(engine="cells")``, all on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.initlib import init_particles as jinit_particles
from ppsim_tpu.io import save_checkpoint as jsave_checkpoint

from ppsim_tpu_torch import native
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.harness import build_parser, config_from_args, main
from ppsim_tpu_torch.io import load_checkpoint

# test_torch_engine.py's bounds for the cuda engine against another run
POS_ATOL, VEL_RTOL, VEL_ATOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's other fixtures run:
    under the suite's parallel workers, torch's threads over the many small
    ops of the plain twins would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cli(n, engine, steps, *extra):
    rc = main(["-n", str(n), "--engine", engine, "--device", "cpu", "--steps",
               str(steps), *extra])
    assert rc == 0


@pytest.mark.parametrize("engine,n,split,steps", [
    ("oracle", 200, 10, 20),  # cadence 1
    ("cuda", 500, 16, 32),    # cadence 8
])
def test_split_run_equals_unsplit(tmp_path, capsys, engine, n, split, steps):
    """A run cut by --checkpoint-out / --resume at a multiple of the rebin
    cadence: the oracle bitwise equal to the whole run, the cuda engine
    (which repacks the resumed state, so its sums go in another order)
    within test_torch_engine.py's bounds."""
    whole, half, rest = (str(tmp_path / f) for f in ("whole.npz", "half.npz", "rest.npz"))
    _cli(n, engine, steps, "-s", "42", "--checkpoint-out", whole)
    _cli(n, engine, split, "-s", "42", "--checkpoint-out", half)
    _cli(n, engine, steps - split, "--resume", half, "--checkpoint-out", rest)
    assert capsys.readouterr().out.count(f"for {n} particles.") == 3
    (a, step_a, cfg_a), (b, step_b, _) = load_checkpoint(whole), load_checkpoint(rest)
    assert step_a == step_b == steps
    assert load_checkpoint(half)[1] == split
    assert cfg_a["num_parts"] == n and a.pos.dtype == torch.float32
    if engine == "oracle":
        assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    else:
        np.testing.assert_allclose(b.pos.numpy(), a.pos.numpy(), rtol=0, atol=POS_ATOL)
        np.testing.assert_allclose(b.vel.numpy(), a.vel.numpy(), rtol=VEL_RTOL,
                                   atol=VEL_ATOL)


def test_resume_reads_a_jax_checkpoint(tmp_path, small_config):
    """A checkpoint of the JAX package's io.save_checkpoint runs under the
    port's --resume: the run continues its step count and equals the port's
    oracle run from the same state."""
    jstate = jinit_particles(small_config, seed=42, method="reference")
    src, out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave_checkpoint(src, jstate, 7, small_config)
    _cli(small_config.num_parts, "oracle", 10, "--resume", src, "--checkpoint-out", out)
    state, step, _ = load_checkpoint(out)
    assert step == 17
    tcfg = config_from_dict(dataclasses.asdict(small_config))
    want = get_engine("oracle", tcfg, device="cpu").run(
        particle_state_from_numpy(*(np.asarray(a) for a in jstate)), nsteps=10)
    assert torch.equal(state.pos, want.state.pos)
    assert torch.equal(state.vel, want.state.vel)


def test_resume_refuses_another_size(tmp_path):
    path = str(tmp_path / "a.npz")
    _cli(100, "oracle", 2, "-s", "3", "--checkpoint-out", path)
    with pytest.raises(SystemExit):
        _cli(120, "oracle", 2, "--resume", path)


@pytest.mark.parametrize("argv,want", [
    ([], (None, None)),
    (["--grid3-repack", "0"], (False, None)),
    (["--grid3-repack", "1", "--grid3-prologue-steps", "16"], (True, 16)),
])
def test_repack_flags_reach_the_config(argv, want):
    args = build_parser().parse_args(["--ndim", "3", *argv])
    cfg = config_from_args(args)
    assert (cfg.grid3_repack, cfg.grid3_prologue_steps) == want
    assert (args.checkpoint_out, args.resume) == (None, None)


@pytest.mark.parametrize("engine", ["oracle", "grid"])
def test_step_state_matches_jax(grid_test_config, engine):
    """One step, state in and state out (tests/test_engines.py's use of
    the JAX step_state), at the JAX package's grid test config."""
    jstate = jinit_particles(grid_test_config, seed=42, method="reference")
    want = jget_engine(engine, grid_test_config).step_state(jstate)
    tcfg = config_from_dict(dataclasses.asdict(grid_test_config))
    got = get_engine(engine, tcfg, device="cpu").step_state(
        particle_state_from_numpy(*(np.asarray(a) for a in jstate)))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_native_cells_matches_native_oracle():
    """The JAX package's tests/test_native.py contract in the port."""
    cfg = SimConfig(num_parts=400)
    pos, vel = native.native_init(400, cfg.size, 42)
    p1, v1 = native.native_run(pos, vel, cfg, 50, engine="oracle")
    p2, v2 = native.native_run(pos, vel, cfg, 50, engine="cells")
    np.testing.assert_allclose(p1, p2, atol=1e-12)
    np.testing.assert_allclose(v1, v2, atol=1e-9)
    assert np.array_equal(native.native_run(pos, vel, cfg, 50)[0], p2)  # the default
    with pytest.raises(KeyError):
        native.native_run(pos, vel, cfg, 1, engine="binned")
