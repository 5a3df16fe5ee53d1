"""The port's ``sharded_tile`` engine on the in-process 2-D ``LocalMesh``:
against the JAX package's ``sharded_tile`` (its plain-op impl, ``"xla"``) on
four CPU devices, against the port's single-device engines on 2 x 2, 1 x 4
and 4 x 1 meshes in both rebin modes (bitwise), against ``sharded_grid`` on
4 x 1, a saved run, the mesh factorization, the ``phase_times`` seam, the
CLI's ``--shards`` and the default device."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines.sharded_tile import ShardedTileEngine as JShardedTileEngine
from ppsim_tpu.engines.sharded_tile import _mesh_factor as jmesh_factor
from ppsim_tpu.initlib import init_particles as jinit_particles

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, particle_state_from_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import mesh_factor
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.initlib import init_particles

# The JAX package's own bound for its tile engine against its grid engine
# (tests/test_sharded_tile.py): the kernels sum the pair forces in another
# order than the plain ops.
ATOL = 2e-6
# grid_test_config and tiny_grid_config (tests/conftest.py): 24 x 24 and
# 11 x 11 bins, capacity 6, cadence 4.
GRID_TEST = SimConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                      evac_capacity=2, rebin_every=4)
TINY = GRID_TEST.with_(num_parts=200)
COL_BLOCK = 8
STEPS = 16
# Steps after which particles have crossed the tile boundaries of every mesh
# (on 2 x 2 the first cross at the fifth rebin, step 20).
STEPS_MIGRATE = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the whole module, its module fixtures included
    (several test workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)], ids=["2x2", "1x4"])
def jax_tile_run(request):
    """The JAX sharded_tile engine (impl "xla") on four CPU devices in
    ``mesh_shape``, col_block 8: grid_test_config, 16 steps (4 rebins)."""
    jcfg = JConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6, evac_capacity=2,
                   rebin_every=4)
    jstate = jinit_particles(jcfg, seed=42, method="reference")
    jeng = JShardedTileEngine(jcfg, devices=jax.devices()[:4], mesh_shape=request.param,
                              col_block=COL_BLOCK, impl="xla")
    jr = jeng.run(jstate, nsteps=STEPS)
    return (request.param, config_from_dict(dataclasses.asdict(jcfg)),
            particle_state_from_numpy(*(np.asarray(a) for a in jstate)),
            dataclasses.asdict(jeng.geom), jr)


@pytest.mark.parametrize("impl", ["cuda", "plain"])
def test_sharded_tile_tracks_jax_sharded_tile(jax_tile_run, impl):
    """The port's sharded_tile (impl cuda: the kernels' twins on the CPU;
    impl plain: the grid engine's ops) against the JAX sharded_tile on the
    same mesh: the same geometry, positions within 2e-6, monitors equal."""
    shape, tcfg, tstate, jgeom, jr = jax_tile_run
    eng = get_engine("sharded_tile", tcfg, device="cpu", mesh_shape=shape,
                     col_block=COL_BLOCK, impl=impl)
    assert dataclasses.asdict(eng.geom) == jgeom
    tr = eng.run(tstate, nsteps=STEPS)
    np.testing.assert_allclose(tr.state.pos.numpy(), np.asarray(jr.state.pos), atol=ATOL)
    for f in ("max_bin_count", "migrate_dropped", "deferred"):
        assert int(getattr(tr.monitors, f)) == int(getattr(jr.monitors, f)), f
    assert float(tr.monitors.max_speed) == pytest.approx(float(jr.monitors.max_speed),
                                                         rel=1e-5)
    eng.check(tr)


def _tile_of_pids(engine, carry):
    """Each live pid's tile, as a dict."""
    return {int(p): d for d, s in zip(engine.mesh.shards, carry.slab)
            for p in s.pid[s.pid >= 0].tolist()}


@pytest.fixture(scope="module", params=["axes", "dirs9"])
def single_device_runs(request):
    """The single-device grid and cuda engines (CPU), grid_test_config,
    STEPS_MIGRATE steps, in one rebin mode."""
    cfg = GRID_TEST.with_(grid_rebin_mode=request.param)
    state = init_particles(cfg, seed=42)
    return cfg, state, {single: get_engine(single, cfg, device="cpu").run(state, nsteps=STEPS_MIGRATE)
                        for single in ("grid", "cuda")}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)], ids=["2x2", "1x4", "4x1"])
def test_sharded_tile_equals_single_device_engines(single_device_runs, shape):
    """sharded_tile on LocalMesh(shape) equals the single-device engines
    bitwise through rebins with cross-tile migration: impl plain the grid
    engine, impl cuda the cuda engine (both on the CPU); monitors equal
    (dirs9's deferred has two definitions, note in cuda_rebin: the tile
    engine's residual count is the cuda engine's). On 4 x 1 it is
    sharded_grid on four strips as well (impl cuda; the plain impls meet
    through the grid engine)."""
    cfg, state, refs = single_device_runs
    for impl, single in (("plain", "grid"), ("cuda", "cuda")):
        ref = refs[single]
        eng = get_engine("sharded_tile", cfg, device="cpu", mesh_shape=shape,
                         col_block=COL_BLOCK, impl=impl)
        res = eng.run(state, nsteps=STEPS_MIGRATE)
        assert torch.equal(res.state.pos, ref.state.pos), impl
        assert torch.equal(res.state.vel, ref.state.vel), impl
        fields = ("max_bin_count", "migrate_dropped", "max_speed")
        if cfg.grid_rebin_mode == "axes" or impl == "cuda":
            fields += ("deferred",)
        for f in fields:
            assert getattr(res.monitors, f) == getattr(ref.monitors, f), (impl, f)
        eng.check(res)
        before = _tile_of_pids(eng, eng.init_carry(state))
        after = _tile_of_pids(eng, res.carry)
        assert sorted(after) == list(range(cfg.num_parts))
        assert sum(before[p] != after[p] for p in after) > 0  # migration
        if shape == (4, 1) and impl == "cuda":
            strips = get_engine("sharded_grid", cfg, device="cpu", shards=4, impl=impl)
            # the same rows; the tiles' columns pad to col_block, the strips' to 128
            assert strips.geom == dataclasses.replace(eng.geom, cols_pad=128)
            other = strips.run(state, nsteps=STEPS_MIGRATE)
            assert torch.equal(res.state.pos, other.state.pos), impl
            assert torch.equal(res.state.vel, other.state.vel), impl
            assert [float(m) for m in res.monitors] == [float(m) for m in other.monitors]


def test_sharded_tile_saved_run_equals_cuda():
    """A saved run (savefreq 5, off the rebin cadence) on a 2 x 2 mesh: the
    frames equal the single-device cuda engine's."""
    state = init_particles(TINY, seed=7)
    ref = get_engine("cuda", TINY, device="cpu").run(state, nsteps=17, savefreq=5)
    res = get_engine("sharded_tile", TINY, device="cpu", mesh_shape=(2, 2),
                     col_block=COL_BLOCK).run(state, nsteps=17, savefreq=5)
    assert res.frames.shape == ref.frames.shape == (4, TINY.num_parts, 2)
    np.testing.assert_array_equal(res.frames, ref.frames)


def test_mesh_factor_near_square_rows_heavy():
    """The port's mesh_factor is the JAX package's _mesh_factor; the engine
    takes it by default, and the geometry pads each tile to 8 rows and
    col_block columns."""
    for n in range(1, 13):
        assert mesh_factor(n) == jmesh_factor(n), n
    assert mesh_factor(4) == (2, 2) and mesh_factor(6) == (3, 2) and mesh_factor(7) == (7, 1)
    eng = get_engine("sharded_tile", TINY, device="cpu", shards=6, col_block=COL_BLOCK)
    assert (eng.Pr, eng.Pc) == (3, 2) and eng.mesh.size == 6
    g = eng.geom
    assert (eng.rows_local, eng.cols_local) == (8, 8)
    assert (g.rows, g.cols, g.rows_pad, g.cols_pad) == (11, 11, 24, 16)
    with pytest.raises(ValueError, match="impl"):
        get_engine("sharded_tile", TINY, device="cpu", shards=4, impl="pallas")
    with pytest.raises(ValueError, match=r"\(P, 1\)"):
        get_engine("sharded_grid", TINY, device="cpu", mesh=eng.mesh)


def test_phase_times_sharded_tile_seam(monkeypatch):
    """profiling.phase_times reaches the tile engine through the sharded
    seam (_phase_disable) and leaves it unset; each variant skips its
    phase. The timer is stubbed: on the CPU its values say nothing."""
    from ppsim_tpu_torch import profiling

    eng = get_engine("sharded_tile", TINY, device="cpu", shards=4, col_block=COL_BLOCK)
    seen = []

    def fake_timeit(step_fn, carry, steps_a, steps_b, device):
        seen.append(eng._phase_disable)
        return {None: 3.0, "move": 1.0, "rebin": 2.5}[eng._phase_disable]

    monkeypatch.setattr(profiling, "timeit_steps", fake_timeit)
    state = init_particles(TINY, seed=1)
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


def test_cli_sharded_tile_on_cpu(capsys):
    """--engine sharded_tile --shards 4: the near-square 2 x 2 mesh (the JAX
    CLI's --cpu-mesh 4), the summary line and a checker PASS."""
    rc = main(["-n", "500", "-s", "42", "--check", "--engine", "sharded_tile",
               "--shards", "4", "--device", "cpu", "--steps", "12"])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "Simulation Time = " in printed and "Correctness check: PASS" in printed


def test_sharded_tile_defaults_to_the_card():
    """With no device the engine builds on CUDA, and raises where there is
    none."""
    if torch.cuda.is_available():
        assert get_engine("sharded_tile", TINY, shards=4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            get_engine("sharded_tile", TINY, shards=4)
