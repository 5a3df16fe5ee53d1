"""The saved-run frame budget (``Engine.run(..., max_device_frame_bytes)``,
the port of the JAX package's chunked saved runs) on a CPU device, where a
streamed frame is copied to host memory as it is taken: streamed and kept
frames agree bit for bit on every engine family, with the JAX package's
chunked run, at the budget's boundary, through the timed runs and
through the 3D repack's replay."""

import dataclasses

import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.base import (
    MAX_DEVICE_FRAME_BYTES, FrameSink, saved_frame_count,
)
from ppsim_tpu_torch.harness import timed_run_repeats
from ppsim_tpu_torch.initlib import init_particles
from test_torch_repack import NSTEPS as REPACK_STEPS, _port as repack_scenario

# tests/test_sharded_grid.py's chunked-run case: 23 steps saved every 3
# (frames after steps 1, 4, ..., 22), so the cadence's phase crosses the
# rebin cadence 4.
NSTEPS, SAVEFREQ = 23, 3
TINY2 = dict(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
             evac_capacity=2, rebin_every=4)
TINY3 = dict(num_parts=400, ndim=3, density=7e-6, grid3_capacity=8,
             evac_capacity=2, rebin3_every=4)
# name -> (engine, config fields, engine options)
FAMILIES = {
    "grid": ("grid", TINY2, {}),
    "grid3d": ("grid3d", TINY3, {}),
    "sharded_grid": ("sharded_grid", TINY2, {"shards": 2}),
    "binned": ("binned", dict(num_parts=500), {}),
}
# Against the JAX engine: test_torch_engine.py's bounds.
POS_ATOL, VEL_RTOL, VEL_ATOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame_bytes(cfg) -> int:
    return cfg.num_parts * cfg.ndim * 4


def _assert_runs_equal(got, want):
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.state.pos.numpy(), want.state.pos.numpy())
    np.testing.assert_array_equal(got.state.vel.numpy(), want.state.vel.numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_frame_budget_matches_unbounded_run(family):
    """A budget of one frame streams every frame; frames and final state
    equal the run that keeps them all on the device, bit for bit."""
    name, fields, options = FAMILIES[family]
    cfg = SimConfig(**fields)
    state = init_particles(cfg, seed=42)
    eng = get_engine(name, cfg, device="cpu", **options)
    one = _frame_bytes(cfg)
    assert eng.frame_sink(NSTEPS, SAVEFREQ, max_device_frame_bytes=one).streams
    assert not eng.frame_sink(NSTEPS, SAVEFREQ).streams
    kept = eng.run(state, NSTEPS, SAVEFREQ)
    streamed = get_engine(name, cfg, device="cpu", **options).run(
        state, NSTEPS, SAVEFREQ, max_device_frame_bytes=one)
    assert streamed.frames.shape == (8, cfg.num_parts, cfg.ndim)
    _assert_runs_equal(streamed, kept)
    for a, b in zip(streamed.monitors, kept.monitors):
        assert a == b


@pytest.fixture(scope="module")
def jax_chunked_run():
    """The JAX grid engine's chunked saved run of tests/test_sharded_grid.py
    (``max_device_frame_bytes`` of one frame), with its inputs."""
    jcfg = JConfig(**TINY2)
    jstate = jinit_particles(jcfg, seed=42, method="reference")
    result = jget_engine("grid", jcfg).run(
        jstate, nsteps=NSTEPS, savefreq=SAVEFREQ,
        max_device_frame_bytes=jcfg.num_parts * 2 * 4)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return tcfg, particle_state_from_numpy(*(np.asarray(a) for a in jstate)), result


@pytest.mark.parametrize("engine", ["cuda", "grid"])
def test_streamed_run_matches_jax_chunked_run(jax_chunked_run, engine):
    """The port's streamed run against the JAX package's chunked one: the
    same frames within test_torch_engine.py's position bound, the final
    state within its bounds, the monitors exact."""
    tcfg, tstate, jr = jax_chunked_run
    tr = get_engine(engine, tcfg, device="cpu").run(
        tstate, NSTEPS, SAVEFREQ, max_device_frame_bytes=_frame_bytes(tcfg))
    assert tr.frames.shape == np.asarray(jr.frames).shape == (8, 200, 2)
    np.testing.assert_allclose(tr.frames, np.asarray(jr.frames), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(tr.state.vel.numpy(), np.asarray(jr.state.vel),
                               rtol=VEL_RTOL, atol=VEL_ATOL)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f


@pytest.mark.parametrize("over", [0, 1])
def test_budget_boundary(over):
    """The JAX rule: 12 steps saved every 4 make max(1, 12 // 4) = 3 frames;
    a budget of exactly 3 frames keeps them on the device, one byte less
    streams them. The frames are the same either way."""
    cfg = SimConfig(**TINY2)
    state = init_particles(cfg, seed=7)
    budget = 3 * _frame_bytes(cfg) - over
    eng = get_engine("cuda", cfg, device="cpu")
    carry, frames = eng.run_steps(eng.init_carry(state), 12, 4,
                                  max_device_frame_bytes=budget)
    assert frames.streams == bool(over)
    assert len(frames) == frames.count == 3
    got = eng.result_of(carry, frames, eng.final_state(carry))
    want = get_engine("cuda", cfg, device="cpu").run(state, 12, 4)
    _assert_runs_equal(got, want)


def test_default_budget_is_the_jax_default():
    """2 GiB: at the main path's n a 2D frame is 167,772,160 bytes, so 10
    frames (``--savefreq 100``) stay and 20 stream; the 3D stretch config's
    10 frames (251,658,240 bytes each) stream."""
    assert MAX_DEVICE_FRAME_BYTES == 2 << 30
    main2 = get_engine("grid", SimConfig(num_parts=20_971_520), device="cpu")
    assert not main2.frame_sink(1000, 100).streams
    assert main2.frame_sink(200, 10).streams
    stretch = get_engine("grid3d", SimConfig(num_parts=20_971_520, ndim=3,
                                             density=7e-6, force_law="lj",
                                             dt=1e-4), device="cpu")
    assert stretch.frame_sink(1000, 100).streams
    assert not main2.frame_sink(1000, 0).streams


@pytest.mark.parametrize("nsteps,savefreq,start", [
    (23, 3, 0), (24, 3, 0), (1, 5, 0), (12, 4, 0), (10, 4, 3), (9, 4, 4),
    (7, 1, 2), (0, 3, 0), (5, 0, 0), (4, 10, 1)])
def test_saved_frame_count_follows_the_cadence(nsteps, savefreq, start):
    """The sink's row count is the number of steps ``run_steps`` saves
    after."""
    want = sum(1 for i in range(start + 1, start + nsteps + 1)
               if savefreq > 0 and (i - 1) % savefreq == 0)
    assert saved_frame_count(nsteps, savefreq, start) == want


@pytest.mark.parametrize("streams", [False, True])
def test_sink_returns_frames_as_taken(streams):
    """Kept or streamed, the host array holds the frames in the order taken,
    as they were when taken; a run that stops early returns the rows it
    took; a sink that took none returns None."""
    frames = [torch.full((5, 2), float(k)) for k in range(3)]
    sink = FrameSink(4, streams)
    assert sink.to_numpy() is None
    for f in frames:
        sink.add(f.clone())
    sink.flush()
    got = sink.to_numpy()
    assert got.shape == (3, 5, 2) and len(sink) == 3
    np.testing.assert_array_equal(got, torch.stack(frames).numpy())


@pytest.mark.parametrize("repeats", [1, 2])
def test_timed_run_streams_the_same_frames(repeats):
    """``timed_run_repeats`` with a one-frame budget returns the frames and
    final state of ``Engine.run`` with the default budget."""
    cfg = SimConfig(**TINY2)
    state = init_particles(cfg, seed=42)
    eng = get_engine("cuda", cfg, device="cpu")
    got, times = timed_run_repeats(eng, state, NSTEPS, SAVEFREQ, repeats=repeats,
                                   max_device_frame_bytes=_frame_bytes(cfg))
    assert len(times) == repeats
    want = get_engine("cuda", cfg, device="cpu").run(state, NSTEPS, SAVEFREQ)
    _assert_runs_equal(got, want)


def test_repack_replay_streams_the_same_frames():
    """tests/test_torch_repack.py's fast movers on ``grid3d``: the timed run
    replays the repack after step 2 between its frames (after steps 1, 3,
    5, 7); under a one-frame budget it streams them, and frames and final
    state equal the run that keeps them."""
    cfg, state = repack_scenario()
    eng = get_engine("grid3d", cfg, device="cpu")
    kept, _ = timed_run_repeats(eng, state, REPACK_STEPS, 2)
    assert eng._last_repack_switch == 2 and eng.capacity == 4
    eng = get_engine("grid3d", cfg, device="cpu")
    assert eng.frame_sink(REPACK_STEPS, 2,
                          max_device_frame_bytes=_frame_bytes(cfg)).streams
    streamed, _ = timed_run_repeats(eng, state, REPACK_STEPS, 2,
                                    max_device_frame_bytes=_frame_bytes(cfg))
    assert eng._last_repack_switch == 2 and eng.capacity == 4
    assert streamed.frames.shape == (4, 10, 3)
    _assert_runs_equal(streamed, kept)


@pytest.mark.parametrize("ndim", [2, 3])
def test_slab_positions_scatter_live_slots_only(ndim):
    """The frame gather (``id_rows``, no boolean mask) against a loop over
    the slots: each live slot's position lands in its id's row, empty
    slots land nowhere, and an id no slot holds keeps a zero row."""
    from ppsim_tpu_torch.ops import grid3d_ops, grid_ops

    cfg = SimConfig(**(TINY3 if ndim == 3 else TINY2))
    eng = get_engine("grid3d" if ndim == 3 else "grid", cfg, device="cpu")
    slab = eng.init_carry(init_particles(cfg, seed=42)).slab
    lost = int(slab.pid.reshape(-1).max())
    slab = slab._replace(pid=torch.where(slab.pid == lost, -1, slab.pid))
    # bin origins as the gather makes them: float32 index times float32 side
    grids = np.meshgrid(*(np.arange(m, dtype=np.float32) for m in slab.pid.shape[1:]),
                        indexing="ij")
    if ndim == 3:
        got = grid3d_ops.slab3_positions(slab, eng.geom, cfg.num_parts)
        g = eng.geom  # bins (y, x, z); planes x, y, z
        origin = [grids[1] * np.float32(g.bsx), grids[0] * np.float32(g.bsy),
                  grids[2] * np.float32(g.bsz)]
        planes = (slab.xl, slab.yl, slab.zl)
    else:
        got = grid_ops.slab_positions(slab, eng.geom, cfg.num_parts)
        origin = [i * np.float32(eng.geom.bin_size) for i in grids]
        planes = (slab.xl, slab.yl)
    want = np.zeros((cfg.num_parts, ndim), np.float32)
    pid = slab.pid.numpy()
    for idx in zip(*np.nonzero(pid >= 0)):
        for k, plane in enumerate(planes):
            want[pid[idx], k] = plane.numpy()[idx] + origin[k][idx[1:]]
    assert got.shape == (cfg.num_parts, ndim)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[lost].any()
