"""The port's particle-list engines (``oracle``, ``binned``, ``binned3d``,
``sharded``) against the JAX package's on the same seeded input, against
each other (the JAX package's own bitwise contracts), against the native
float64 oracle, and through ``phase_times``, the CLI and ``get_engine``.

The JAX engines run jitted (``engine.run``, ``jax.jit(step_carry)``), never
step by step: the eager JAX sharded step costs minutes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines import get_engine as jget_engine
from ppsim_tpu.engines.sharded import ShardedEngine as JShardedEngine
from ppsim_tpu.initlib import init_particles as jinit_particles
from ppsim_tpu.state import ParticleState as JParticleState

from ppsim_tpu_torch import native
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import (
    config_from_dict, particle_state_from_numpy, shard_carry_from_numpy,
    shard_carry_to_numpy,
)
from ppsim_tpu_torch.engines import engine_names, get_engine
from ppsim_tpu_torch.harness import build_parser, config_from_args, main
from ppsim_tpu_torch.profiling import phase_times
from ppsim_tpu_torch.state import make_state

N = 1500
# Against the JAX engines: test_torch_engine.py's bounds (positions within
# 1e-5, velocities rtol 1e-4 and atol 1e-4), over 40 steps. The JAX jit
# computes the repulsive law's cutoff / sqrt(r2) as cutoff * rsqrt(r2),
# which XLA's CPU backend rounds differently from a division by the
# correctly rounded sqrt (the port's, and the JAX package's eager ops'): an
# ulp of a close pair's coefficient, which grows through the encounter. At
# N = 1500 from the reference init the first close encounter comes at step
# ~20; over 50 steps the velocities part by 4e-4, over 40 by 1.1e-4 (|v| up
# to 1.7, so inside rtol + atol).
STEPS, SAVEFREQ = 40, 10
POS_ATOL, VEL_RTOL, VEL_ATOL = 1e-5, 1e-4, 1e-4
# The 3D config of the JAX package's tests/test_3d.py (~0.6 interacting
# neighbours a particle); its bound for binned3d against the oracle.
CFG3 = dict(num_parts=800, ndim=3, density=7e-6, bin_capacity=8)
ATOL3 = 1e-6
# name -> (engine, JAX config fields, port engine options)
CASES = {
    "oracle": ("oracle", {}, {}),
    "binned": ("binned", {}, {}),
    "sharded-P2": ("sharded", {}, {"shards": 2}),
    "sharded-P4": ("sharded", {}, {"shards": 4}),
    "oracle3d": ("oracle", CFG3, {}),
    "binned3d-lj": ("binned3d", dict(CFG3, force_law="lj", dt=1e-4), {}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(jfields, seed=42):
    jcfg = JConfig(**({"num_parts": N} | jfields))
    method = "fast" if jcfg.ndim == 3 else "reference"
    jstate = jinit_particles(jcfg, seed=seed, method=method)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, jstate, tcfg, particle_state_from_numpy(*(np.asarray(a) for a in jstate))


@pytest.fixture(scope="module", params=list(CASES))
def jax_case(request):
    """The JAX engine's jitted run of a case (frames every SAVEFREQ steps),
    and the port's config and state from the same input."""
    name, jfields, options = CASES[request.param]
    jcfg, jstate, tcfg, tstate = _inputs(jfields)
    if name == "sharded":
        jeng = JShardedEngine(jcfg, devices=jax.devices()[:options["shards"]])
    else:
        jeng = jget_engine(name, jcfg)
    return name, options, tcfg, tstate, jeng.run(jstate, nsteps=STEPS, savefreq=SAVEFREQ)


def test_engine_tracks_jax_engine(jax_case):
    """Frames and final positions within 1e-5, velocities within rtol/atol
    1e-4, monitors equal (max_bin_count, dropped, deferred)."""
    name, options, tcfg, tstate, jr = jax_case
    tr = get_engine(name, tcfg, device="cpu", **options).run(
        tstate, nsteps=STEPS, savefreq=SAVEFREQ)
    assert tr.frames.shape == np.asarray(jr.frames).shape
    np.testing.assert_allclose(tr.frames, np.asarray(jr.frames), rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(tr.state.vel.numpy(), np.asarray(jr.state.vel),
                               rtol=VEL_RTOL, atol=VEL_ATOL)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    tr.check(tcfg)


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs of N = 1500 from the reference init, 60 steps,
    frames every 10 (the JAX package's tests/test_engines.py setup), keyed
    by engine name and shard count."""
    _, _, tcfg, tstate = _inputs({})
    runs = {}
    for name, shards in (("oracle", None), ("binned", None), ("sharded", 2), ("sharded", 4)):
        opts = {} if shards is None else {"shards": shards}
        runs[name, shards] = get_engine(name, tcfg, device="cpu", **opts).run(
            tstate, nsteps=60, savefreq=10)
    return tcfg, runs


def test_binned_matches_oracle_bitexact(port_runs):
    tcfg, runs = port_runs
    np.testing.assert_array_equal(runs["binned", None].frames, runs["oracle", None].frames)
    runs["binned", None].check(tcfg)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_matches_binned_bitexact(port_runs, shards):
    tcfg, runs = port_runs
    got, want = runs["sharded", shards], runs["binned", None]
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.state.vel.numpy(), want.state.vel.numpy())
    got.check(tcfg)
    assert int(got.monitors.max_bin_count) == int(want.monitors.max_bin_count)


@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_binned3d_matches_oracle3d(law):
    """The JAX package's 3D contract (tests/test_3d.py), in the port."""
    fields = dict(CFG3, force_law="lj", dt=1e-4) if law == "lj" else CFG3
    _, _, tcfg, tstate = _inputs(fields)
    r1 = get_engine("oracle", tcfg, device="cpu").run(tstate, nsteps=40, savefreq=10)
    r2 = get_engine("binned3d", tcfg, device="cpu").run(tstate, nsteps=40, savefreq=10)
    np.testing.assert_allclose(r2.frames, r1.frames, rtol=0, atol=ATOL3)
    r2.check(tcfg)


def _grid_order(engine, state, steps):
    """The engine's particle ids in grid order after ``steps`` steps: one
    more step with both phases off ("force+move", a pure re-sort) leaves the
    list bin-sorted, and, in the sharded engine, no particle in transit."""
    carry = engine.init_carry(state)
    for _ in range(steps):
        carry = engine.step_carry(carry)
    engine._phase_disable = "force+move"
    try:
        carry = engine.step_carry(carry)
    finally:
        engine._phase_disable = None
    if isinstance(carry.pid, list):
        return torch.cat([p[p >= 0] for p in carry.pid]).numpy()
    return carry.pid.numpy()


def test_sharded_keeps_binned_within_bin_order():
    """Within a bin, the strips keep binned's order, so the pair terms of a
    bin are summed in the same order: an immigrant from the strip above goes
    first in its new bin (it came from a lower bin). Particle 0 crosses from
    strip 0 into a bin of strip 1 that holds three particles; the strips'
    ids in grid order, strip by strip, are binned's, slot for slot, at every
    step, and after 60 steps of the reference init's n = 1500 on 4 strips."""
    cl = np.array([[0.1595, 0.150], [0.166, 0.1575], [0.165, 0.1435], [0.170, 0.150]])
    g = 0.015 + 0.03 * np.arange(10)
    lattice = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    lattice = lattice[np.linalg.norm(lattice - [0.165, 0.15], axis=1) > 0.02]
    pos = np.concatenate([cl, lattice]).astype(np.float32)
    vel = np.zeros_like(pos)
    vel[0] = (2.0, 0.0)  # x 0.1595 -> 0.1605: strip 0's last row -> strip 1's first
    n = pos.shape[0]
    cfg = SimConfig(num_parts=n, density=0.32 ** 2 / n)  # 16 x 16 bins, strips of 8 rows
    st = make_state(pos, vel)
    binned = get_engine("binned", cfg, device="cpu")
    sharded = get_engine("sharded", cfg, device="cpu", shards=2)
    for steps in range(4):
        want = _grid_order(binned, st, steps)
        np.testing.assert_array_equal(_grid_order(sharded, st, steps), want)
    assert list(want[np.isin(want, [0, 1, 2, 3])]) == [0, 1, 2, 3]  # one bin, 0 first

    _, _, tcfg, tstate = _inputs({})
    np.testing.assert_array_equal(
        _grid_order(get_engine("sharded", tcfg, device="cpu", shards=4), tstate, 60),
        _grid_order(get_engine("binned", tcfg, device="cpu"), tstate, 60))


def test_sharded_far_mover_deferred_not_dropped():
    """A particle crossing more than one strip a step (injected) hops one
    strip a step: deferred > 0, nothing dropped, nothing duplicated. Both
    packages start from one carry (the JAX engine's, converted) and the
    JAX engine steps through jax.jit: equal pids and monitors, positions
    within 1e-5. The port's own init_carry gives the JAX carry bitwise."""
    jcfg = JConfig(num_parts=256)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jeng = JShardedEngine(jcfg, devices=jax.devices()[:4])
    teng = get_engine("sharded", tcfg, device="cpu", shards=4)
    assert (teng.n_cap, teng.m_cap, teng.rows_per_shard) == (jeng.n_cap, jeng.m_cap,
                                                             jeng.rows_per_shard)
    jstate = jinit_particles(jcfg, seed=1, method="reference")
    vel = np.asarray(jstate.vel).copy()
    jump = 2.1 * jeng.rows_per_shard * jcfg.bin_size  # two strips in one dt
    vel[0] = (jump / jcfg.dt, 0.0)
    jcarry = jeng.init_carry(JParticleState(jstate.pos, jnp.asarray(vel)))
    tcarry = shard_carry_from_numpy(*(np.asarray(a) for a in jcarry[:3]), shards=4)
    own = teng.init_carry(particle_state_from_numpy(np.asarray(jstate.pos), vel))
    for a, b in zip(shard_carry_to_numpy(own), shard_carry_to_numpy(tcarry)):
        np.testing.assert_array_equal(a, b)

    jstep = jax.jit(jeng.step_carry)
    for _ in range(4):
        jcarry = jstep(jcarry)
        tcarry = teng.step_carry(tcarry)
    tmon = [int(m) for m in tcarry.monitors.to_host()]
    assert tmon[1] == 0 and tmon[3] > 0  # nothing dropped; deferred
    assert tmon == [int(np.asarray(m)) for m in jcarry.monitors]
    pos, vel_t, pid = shard_carry_to_numpy(tcarry)
    np.testing.assert_array_equal(pid, np.asarray(jcarry.pid))
    np.testing.assert_allclose(pos, np.asarray(jcarry.pos), rtol=0, atol=POS_ATOL)
    alive = pid[pid >= 0]
    assert alive.size == jcfg.num_parts  # nothing lost
    assert np.unique(alive).size == jcfg.num_parts  # nothing duplicated


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_oracle_tracks_native_oracle(dtype):
    """10 steps of 400 particles from the native initializer against the
    native float64 O(N^2) engine: float32 within the JAX package's band for
    its f32 path (1e-4, tests/test_native.py), float64 within 1e-9 (the
    same test's f64 bound; the summation order and the wall fold differ,
    so not bitwise)."""
    cfg = SimConfig(num_parts=400, dtype=dtype)
    pos, vel = native.native_init(400, cfg.size, 42)
    st = make_state(pos, vel, dtype=cfg.torch_dtype)
    res = get_engine("oracle", cfg, device="cpu").run(st, nsteps=10, savefreq=5)
    assert res.frames.dtype == np.dtype(dtype)
    npos, _ = native.native_run(pos, vel, cfg, 10, engine="oracle")
    err = float(np.abs(res.state.pos.double().numpy() - npos).max())
    assert err < (1e-4 if dtype == "float32" else 1e-9), err


@pytest.mark.parametrize("name,fields,options", [
    ("oracle", {}, {}), ("binned", {}, {}), ("sharded", {}, {"shards": 2}),
    ("binned3d", CFG3, {})])
def test_phase_times_particle_engines(name, fields, options):
    """phase_times on a CPU particle-list engine: the four phases, each >= 0
    (a timing on a loaded CPU says nothing stronger), the seam restored."""
    tcfg = SimConfig(**(fields | {"num_parts": 100}))
    eng = get_engine(name, tcfg, device="cpu", **options)
    from ppsim_tpu_torch.initlib import init_particles

    pt = phase_times(eng, init_particles(tcfg, seed=42, method="fast"), steps=2)
    assert set(pt) == {"step", "force", "move", "other"}
    assert all(v >= 0.0 for v in pt.values())
    assert eng._phase_disable is None


def test_phase_seams_disable_the_phases():
    """"force" zeroes the accelerations (the move still runs); "force+move"
    leaves the state where it was; the bins are rebuilt either way."""
    _, _, tcfg, tstate = _inputs({"num_parts": 300})
    eng = get_engine("binned", tcfg, device="cpu")
    carry = eng.init_carry(tstate)
    eng._phase_disable = "force"
    free = eng.step_carry(carry)
    eng._phase_disable = "force+move"
    still = eng.step_carry(carry)
    eng._phase_disable = None
    order = torch.sort(still.pid.long()).indices
    np.testing.assert_array_equal(still.pos[order].numpy(), tstate.pos.numpy())
    order = torch.sort(free.pid.long()).indices
    np.testing.assert_allclose(free.vel[order].numpy(), tstate.vel.numpy())


def test_cli_particle_flags(tmp_path, capsys):
    """--dtype, --bin-scale and --bin-capacity reach the config, and
    --dtype float64 runs float64 through the whole path (the oracle's
    frames); binned and sharded --shards 2 pass --check on the CPU."""
    args = build_parser().parse_args(["-n", "100", "--dtype", "float64",
                                      "--bin-scale", "2.5", "--bin-capacity", "12"])
    cfg = config_from_args(args)
    assert (cfg.dtype, cfg.bin_scale, cfg.bin_capacity) == ("float64", 2.5, 12)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--dtype", "bfloat16"])
    metrics = str(tmp_path / "m.jsonl")
    for extra in (["--engine", "binned", "--dtype", "float64", "--bin-capacity", "12"],
                  ["--engine", "sharded", "--shards", "2", "--bin-scale", "2.5"]):
        rc = main(["-n", "500", "-s", "42", "--check", "--device", "cpu", "--steps", "40",
                   "--metrics", metrics, *extra])
        assert rc == 0
        assert "Correctness check: PASS" in capsys.readouterr().out
    import json

    recs = [json.loads(line) for line in open(metrics)]
    assert [r["dtype"] for r in recs] == ["float64", "float32"]
    assert [r["capacity"] for r in recs] == [12, 8]
    eng = get_engine("oracle", cfg.with_(num_parts=50), device="cpu")
    from ppsim_tpu_torch.initlib import init_particles

    res = eng.run(init_particles(eng.config, seed=3), nsteps=3, savefreq=1)
    assert res.frames.dtype == np.float64 and res.state.vel.dtype == torch.float64


@pytest.mark.parametrize("name", ["oracle", "binned", "binned3d", "sharded"])
def test_get_engine_defaults_to_the_card(name):
    """No device asked for: the card, and without one a RuntimeError,
    never a quiet CPU run."""
    cfg = SimConfig(**((CFG3 if name == "binned3d" else {}) | {"num_parts": 200}))
    assert name in engine_names(cfg.ndim)
    if torch.cuda.is_available():
        assert get_engine(name, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            get_engine(name, cfg)
