"""Port parity: SimConfig, geometry chooser, physics, init, io and checker of
ppsim_tpu_torch against the JAX package (pure Python / numpy sizes)."""

import dataclasses

import numpy as np
import pytest
import torch

import ppsim_tpu.checker as jchecker
import ppsim_tpu.initlib as jinit
import ppsim_tpu.io as jio
import ppsim_tpu.physics as jphys
from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.ops.grid_ops import SlabGeometry as JGeom

import ppsim_tpu_torch.checker as tchecker
import ppsim_tpu_torch.initlib as tinit
import ppsim_tpu_torch.io as tio
import ppsim_tpu_torch.physics as tphys
from ppsim_tpu_torch.convert import config_from_dict
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry as TGeom

DERIVED = ("size", "min_r", "bin_size", "bins_per_side", "num_bins",
           "grid_bin_size", "grid_bins_per_side", "grid_slack",
           "grid3_bin_size", "grid3_bins_per_side", "law_params")


def _pair(**kw):
    j = JConfig(**kw)
    return j, config_from_dict(dataclasses.asdict(j))


@pytest.mark.parametrize("rebin_every", [8, 11])
@pytest.mark.parametrize("n", [200, 1000, 262_144, 1_048_576, 4_194_304,
                               20_971_520])
def test_geometry_and_derived_values_match(n, rebin_every):
    jc, tc = _pair(num_parts=n, rebin_every=rebin_every)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    assert dataclasses.asdict(TGeom.for_config(tc)) == dataclasses.asdict(
        JGeom.for_config(jc))


def test_main_path_geometry():
    """bench.py's 2D headline (n = 20.97M, cadence 11) picks the lane-snapped
    1664 x 1664 grid with capacity 14 in both packages."""
    _, tc = _pair(num_parts=20_971_520, rebin_every=11)
    g = TGeom.for_config(tc)
    assert (g.rows, g.cols, g.rows_pad, g.cols_pad, g.capacity) == (
        1664, 1664, 1664, 1664, 14)


@pytest.mark.parametrize("kw", [
    dict(grid_snap_lanes=False, num_parts=4_194_304),
    dict(grid_capacity=9, num_parts=1_048_576),
    dict(grid_bin_scale=3.0, grid_capacity=6, num_parts=1000),
    dict(force_law="lj", num_parts=5000, dt=1e-4),
])
def test_config_variants_match(kw):
    jc, tc = _pair(**kw)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    assert dataclasses.asdict(TGeom.for_config(tc)) == dataclasses.asdict(
        JGeom.for_config(jc))
    assert tc.torch_dtype == torch.float32


@pytest.mark.parametrize("bad", [
    dict(grid_bin_scale=1.0), dict(rebin_every=0), dict(grid_capacity=0),
    dict(force_law="gravity"), dict(grid_rebin_mode="x"), dict(num_parts=0),
])
def test_validate_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        JConfig(**bad).validate()
    with pytest.raises(ValueError):
        config_from_dict(dataclasses.asdict(JConfig())).with_(**bad).validate()


def test_physics_parity():
    """Pair coefficients on random r2 and the multi-bounce wall fold agree with
    the JAX physics to float32 rounding."""
    rng = np.random.default_rng(0)
    cfg = JConfig()
    dx = rng.uniform(-0.012, 0.012, 4096).astype(np.float32)
    dy = rng.uniform(-0.012, 0.012, 4096).astype(np.float32)
    ja = jphys.accel_from_deltas(dx, dy, cfg.cutoff, cfg.min_r, cfg.mass)
    ta = tphys.accel_from_deltas(torch.from_numpy(dx), torch.from_numpy(dy),
                                 cfg.cutoff, cfg.min_r, cfg.mass)
    for j, t in zip(ja, ta):
        # (1 - cutoff/r) cancels near the cutoff and XLA may rewrite the
        # divisions, so the bound is relative to the largest value
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-6 * np.abs(j).max())
    L = 1.0
    pos = rng.uniform(-5.3, 6.7, (512, 2)).astype(np.float32)  # up to 6 bounces
    vel = rng.normal(size=(512, 2)).astype(np.float32)
    jp, jv = jphys.reflect_walls(pos, vel, L)
    tp, tv = tphys.reflect_walls(torch.from_numpy(pos), torch.from_numpy(vel), L)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    acc = rng.normal(size=(512, 2)).astype(np.float32)
    jp, jv = jphys.verlet_step(pos, vel, acc, 0.0005, L)
    tp, tv = tphys.verlet_step(torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.from_numpy(acc), 0.0005, L)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-7)


def test_mt19937_and_reference_init_bitwise():
    g1, g2 = jinit.MT19937(5489), tinit.MT19937(5489)
    assert [g1.next_u32() for _ in range(1500)] == [g2.next_u32() for _ in range(1500)]
    jp, jv = jinit.init_particles_reference(777, 0.6, 42)
    tp, tv = tinit.init_particles_reference(777, 0.6, 42)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)
    jc, tc = _pair(num_parts=777)
    st = tinit.init_particles(tc, seed=42)
    jst = jinit.init_particles(jc, seed=42, method="reference")
    assert st.pos.dtype == torch.float32 and st.pos.shape == (777, 2)
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    np.testing.assert_array_equal(st.vel.numpy(), np.asarray(jst.vel))


def test_python_init_loop_matches_native(monkeypatch):
    """The numpy MT19937 path and the native path give the same state."""
    import ppsim_tpu_torch.native as tnative

    native = tinit.init_particles_reference(300, 0.4, 7)
    monkeypatch.setattr(tnative, "available", lambda: False)
    py = tinit.init_particles_reference(300, 0.4, 7)
    np.testing.assert_array_equal(native[0], py[0])
    np.testing.assert_array_equal(native[1], py[1])


def test_trajectory_bytes_and_check_result_match(tmp_path):
    jc, tc = _pair(num_parts=400)
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, jc.size, (3, 400, 2)).astype(np.float32)
    jio.write_trajectory(str(tmp_path / "j.txt"), frames, jc.size)
    tio.write_trajectory(str(tmp_path / "t.txt"), frames, tc.size)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    back, size = tio.read_trajectory(str(tmp_path / "t.txt"))
    assert back.shape == frames.shape and size == pytest.approx(tc.size, rel=1e-5)
    assert tuple(tchecker.check_frames(frames, tc)) == tuple(
        jchecker.check_frames(frames, jc))
    assert tuple(tchecker.check_trajectory(str(tmp_path / "t.txt"), tc)) == tuple(
        jchecker.check_trajectory(str(tmp_path / "j.txt"), jc))


def test_large_frame_stats_native_and_numpy_agree():
    """Above 20,000 particles the checker uses the native cell-list pass (each
    unordered pair once); the numpy cell-list fallback (each pair from both
    sides) and the JAX package's pass give the same min and mean."""
    from ppsim_tpu_torch import native

    if not native.available():
        pytest.skip("the native library needs g++")
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 3.5, (25_000, 2))
    nat = tchecker.frame_distance_stats(pos, 0.01)
    npy = tchecker.frame_distance_stats(pos, 0.01, use_native=False)
    ref = jchecker.frame_distance_stats(pos, 0.01, use_native=False)
    assert npy == ref
    assert 2 * nat[2] == npy[2] and nat[0] == pytest.approx(npy[0])
    assert 2 * nat[1] == pytest.approx(npy[1])


def test_checkpoint_roundtrip(tmp_path):
    _, tc = _pair(num_parts=50)
    st = tinit.init_particles(tc, seed=9)
    tio.save_checkpoint(str(tmp_path / "c.npz"), st, 17, tc)
    back, step, cfg = tio.load_checkpoint(str(tmp_path / "c.npz"))
    assert step == 17 and cfg["num_parts"] == 50
    assert torch.equal(back.pos, st.pos) and torch.equal(back.vel, st.vel)
    jst, jstep, _ = jio.load_checkpoint(str(tmp_path / "c.npz"))
    assert jstep == 17
    np.testing.assert_array_equal(np.asarray(jst.pos), st.pos.numpy())
