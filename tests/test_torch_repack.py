"""The 3D capacity-phase repack of ``grid3d`` and ``cuda3d`` (on a CPU
device, so the kernel wrappers run their plain twins) against the JAX
``grid3d`` engine's phased timed run, and the port's own contracts:
the repack is storage relocation only, a failed attempt leaves the run as
it was, the law and the config switch it, and a drop escalation raises its
target.

The scenario is the JAX package's (tests/test_3d_grid.py): ten particles,
five packed into one bin at pairwise distances past the cutoff, so no force
acts; the movers cross into distinct neighbour bins, and the packing
capacity 5 (the auto-raise of a hand capacity 4) can drop back to 4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.harness import timed_run_repeats as jtimed_run_repeats
from ppsim_tpu.state import ParticleState as JParticleState

from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.base import Monitors, RunResult
from ppsim_tpu_torch.harness import timed_run_repeats
from ppsim_tpu_torch.ops import grid3d_ops

# box side 0.15, bin side 0.03; dt 0.01 at |v| = 0.9 carries a mover 0.003
# from its face into the neighbour bin in one step, inside the slack 0.01
REPACK = dict(num_parts=10, ndim=3, density=3.375e-4, grid3_bin_scale=3.0,
              grid3_capacity=4, evac_capacity=4, rebin3_every=1, dt=0.01,
              grid3_prologue_steps=2)
NSTEPS = 8
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's other fixtures run:
    under the suite's parallel workers, torch's threads over the many small
    ops of the plain twins would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cluster(speed=0.9):
    """(pos, vel) float32: five movers in the bin (2, 2, 2), each 0.003 from
    a distinct face and moving through it at ``speed``, and five singles at
    rest in the corners."""
    pos = np.array([
        [0.087, 0.075, 0.075], [0.063, 0.075, 0.075],
        [0.075, 0.087, 0.075], [0.075, 0.063, 0.075],
        [0.075, 0.075, 0.087],
        [0.015, 0.015, 0.015], [0.135, 0.015, 0.015], [0.015, 0.135, 0.015],
        [0.015, 0.015, 0.135], [0.135, 0.135, 0.135],
    ], np.float32)
    vel = np.zeros((10, 3), np.float32)
    for row, (axis, sign) in enumerate(((0, 1), (0, -1), (1, 1), (1, -1), (2, 1))):
        vel[row, axis] = sign * speed
    return pos, vel


def _port(speed=0.9, **over):
    """The port's config and initial state of the scenario."""
    return (config_from_dict(dict(REPACK, **over)),
            particle_state_from_numpy(*_cluster(speed)))


@pytest.fixture(scope="module")
def roomy():
    """The fast movers' run at capacity 6, frames every 2 steps: the
    cluster fits from the start, so the run has no phases."""
    cfg, state = _port(grid3_capacity=6)
    eng = get_engine("grid3d", cfg, device="cpu")
    result, _ = timed_run_repeats(eng, state, NSTEPS, 2)
    assert eng.repack_plan(NSTEPS) is None and eng.capacity == 6
    return result


def _assert_state_close(got, want):
    np.testing.assert_allclose(got.pos.numpy(), want.pos.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.vel.numpy(), want.vel.numpy(), atol=ATOL)


@pytest.fixture(scope="module")
def jax_slow_movers():
    """The JAX phased timed run on the slow movers (0.12: the 0.003 face
    gap is crossed at step 3, so the attempt at step 2 fails), one attempt
    a step boundary (chunk_steps = 1 = the rebin cadence)."""
    pos, vel = _cluster(0.12)
    eng = jget_engine("grid3d", JConfig(**REPACK))
    result, _ = jtimed_run_repeats(
        eng, JParticleState(jnp.asarray(pos), jnp.asarray(vel)), NSTEPS, 0,
        repeats=1, chunk_steps=1)
    return eng, result


@pytest.mark.parametrize("engine", ["grid3d", "cuda3d"])
def test_repack_matches_jax_phased_run(jax_slow_movers, engine):
    """Packing capacity, attempts, switch step, final capacity and monitors
    exactly the JAX engine's; the final state within 1e-6."""
    jeng, jres = jax_slow_movers
    cfg, state = _port(0.12)
    eng = get_engine(engine, cfg, device="cpu")
    result, _ = timed_run_repeats(eng, state, NSTEPS, 0)
    assert eng._pack_capacity == jeng._pack_capacity == 5
    assert eng._last_repack_attempts == list(jeng._last_repack_attempts)
    assert eng._last_repack_attempts[0] == 2 and len(eng._last_repack_attempts) >= 2
    assert eng._last_repack_switch == jeng._last_repack_switch \
        == eng._last_repack_attempts[-1]
    assert eng.capacity == jeng.geom.capacity == 4
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(result.monitors, f)) == int(getattr(jres.monitors, f)), f
    np.testing.assert_allclose(result.state.pos.numpy(), np.asarray(jres.state.pos),
                               atol=ATOL)
    np.testing.assert_allclose(result.state.vel.numpy(), np.asarray(jres.state.vel),
                               atol=ATOL)
    eng.check(result)


def _count_steps(eng, monkeypatch):
    """The global step indices ``eng`` runs, in order."""
    steps, step = [], eng.step
    monkeypatch.setattr(eng, "step", lambda carry, i: (steps.append(i), step(carry, i))[1])
    return steps


def test_fast_movers_commit_at_the_first_attempt(roomy, monkeypatch):
    """Discovery stops at the commit after step 2; one rebin period (step
    3) at capacity 4 ends the warm-up; the timed runs take steps 1-8."""
    cfg, state = _port()
    eng = get_engine("cuda3d", cfg, device="cpu")
    steps = _count_steps(eng, monkeypatch)
    result, times = timed_run_repeats(eng, state, NSTEPS, 0, repeats=2)
    assert len(times) == 2
    assert steps == [1, 2, 3] + list(range(1, NSTEPS + 1)) * 2
    assert eng._pack_capacity == 5
    assert eng._last_repack_attempts == [2] and eng._last_repack_switch == 2
    assert eng.capacity == 4 and result.carry.slab.xl.shape[0] == 4
    eng.check(result)
    assert int(result.monitors.migrate_dropped) == 0
    assert int(result.monitors.max_bin_count) <= 4
    _assert_state_close(result.state, roomy.state)


def test_saved_run_repacks_and_keeps_its_frames(roomy):
    """Frames after steps 1, 3, 5, 7 (the reference cadence), a repack
    after step 2 between them."""
    cfg, state = _port()
    eng = get_engine("grid3d", cfg, device="cpu")
    result, _ = timed_run_repeats(eng, state, NSTEPS, 2)
    assert eng._last_repack_switch == 2 and eng.capacity == 4
    eng.check(result)
    assert result.frames.shape == (4, 10, 3)
    np.testing.assert_allclose(result.frames, roomy.frames, atol=ATOL)
    _assert_state_close(result.state, roomy.state)


def test_repack_off_keeps_the_packing_capacity(roomy):
    cfg, state = _port(grid3_repack=False)
    eng = get_engine("cuda3d", cfg, device="cpu")
    result, _ = timed_run_repeats(eng, state, NSTEPS, 0)
    assert eng._pack_capacity == 5 and eng.repack_plan(NSTEPS) is None
    assert eng.capacity == 5 and result.carry.slab.xl.shape[0] == 5
    eng.check(result)
    _assert_state_close(result.state, roomy.state)


def test_lj_opts_out_by_default():
    cfg, state = _port(force_law="lj", dt=1e-4)
    eng = get_engine("grid3d", cfg, device="cpu")
    eng.init_carry(state)
    assert eng._pack_capacity == 6  # packing 5 + LJ's run-tail slot
    assert eng.repack_plan(1000) is None
    rep = get_engine("grid3d", cfg.with_(grid3_repack=True), device="cpu")
    rep.init_carry(state)
    assert rep.repack_plan(1000) == (2, 480)


def test_plan_window_follows_the_cadence():
    """The first attempt rounds up to a rebin step; the last retry is at
    min(nsteps / 2, 480) or the first attempt."""
    cfg, state = _port(rebin3_every=4, grid3_prologue_steps=None)
    eng = get_engine("grid3d", cfg, device="cpu")
    assert eng.repack_plan(1000) is None  # before the packing is measured
    eng.init_carry(state)
    assert eng.repack_plan(1000) == (40, 480)
    assert eng.repack_plan(100) == (40, 50)
    assert eng.repack_plan(60) == (40, 40)
    assert eng.repack_plan(40) is None
    eng = get_engine("grid3d", cfg.with_(grid3_prologue_steps=5), device="cpu")
    eng.init_carry(state)
    assert eng.repack_plan(1000) == (8, 480)


def test_failed_attempts_equal_repack_off_bitwise(monkeypatch):
    """Movers too slow to leave the bin in the run: every attempt (steps 2,
    3, 4) fails, discovery ends at the last one, and the run is bitwise the
    run without the repack, its final slab included."""
    cfg, state = _port(0.01)
    eng = get_engine("cuda3d", cfg, device="cpu")
    steps = _count_steps(eng, monkeypatch)
    result, _ = timed_run_repeats(eng, state, NSTEPS, 0)
    assert eng._last_repack_attempts == [2, 3, 4]
    assert steps == [1, 2, 3, 4, 5] + list(range(1, NSTEPS + 1))
    assert eng._last_repack_switch is None and eng.capacity == 5
    off = get_engine("cuda3d", cfg.with_(grid3_repack=False), device="cpu")
    ref, _ = timed_run_repeats(off, state, NSTEPS, 0)
    assert torch.equal(result.state.pos, ref.state.pos)
    assert torch.equal(result.state.vel, ref.state.vel)
    for got, want in zip(result.carry.slab, ref.carry.slab):
        assert torch.equal(got, want)
    assert [int(v) for v in result.monitors] == [int(v) for v in ref.monitors]


def test_escalated_floor_stops_a_repack_below_it(monkeypatch):
    """An auto-capacity engine (base capacity 4 here) packs at 5 and
    repacks to 4; after a drop escalates it to 5, the re-run packs at 5 and
    makes no attempt, so it never goes back to the capacity that dropped."""
    monkeypatch.setattr(grid3d_ops, "_AUTO3_BASE_CAPACITY", 4)
    cfg, state = _port(grid3_capacity=None, grid3_spill=False)
    eng = get_engine("grid3d", cfg, device="cpu")
    timed_run_repeats(eng, state, NSTEPS, 0)
    assert eng._last_repack_switch == 2 and eng.capacity == 4
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    dropped = RunResult(None, None, Monitors(i32(4), i32(3), torch.tensor(0.0), i32(0)))
    assert eng.maybe_escalate_after_drop(dropped)
    assert eng.capacity == 5 and eng._repack_target() == 5
    result, _ = timed_run_repeats(eng, state, NSTEPS, 0)
    assert eng.repack_plan(NSTEPS) is None
    assert eng.capacity == 5 and result.carry.slab.xl.shape[0] == 5
    eng.check(result)


def test_sharded_grid3d_makes_no_plan():
    cfg, state = _port()
    eng = get_engine("sharded_grid3d", cfg, device="cpu", shards=2)
    eng.init_carry(state)
    assert eng._pack_capacity == 5
    assert eng.repack_plan(NSTEPS) is None
    assert get_engine("grid3d", cfg, device="cpu")._repack_ok
