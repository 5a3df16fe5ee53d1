"""Port parity: the plain slab-grid ops of ppsim_tpu_torch against the JAX
package on identical numpy inputs (pack, unpack, force + move, rebin)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.ops.pallas_rebin import rebin_axes_call_pallas

from ppsim_tpu_torch.convert import slab_state_from_numpy
from ppsim_tpu_torch.ops import grid_ops as T
from ppsim_tpu_torch.ops.cuda_rebin import (
    grid_rebin_axes_cuda, rebin_axes_call_cuda, rebin_axes_call_plain,
)
from ppsim_tpu_torch.ops.grid_ops import monitors_of_counts

from test_grid_ops import _stress_slab

STRESS = dict(rows=13, cols=100, rows_pad=16, cols_pad=128, capacity=4,
              bin_size=0.05)


def _geoms(jcfg):
    jg = J.SlabGeometry.for_config(jcfg)
    return jg, T.SlabGeometry(**dataclasses.asdict(jg))


def _to_torch(jslab):
    return slab_state_from_numpy(*(np.asarray(f) for f in jslab))


def _assert_slab_equal(tslab, jslab):
    for f, t, j in zip(jslab._fields, tslab, jslab):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)


def _drifted(jcfg, seed, frac):
    """Packed reference-init slab with every live particle drifted by up to
    ``frac`` bins (numpy, from ``seed``): both packages get the same state."""
    from ppsim_tpu.initlib import init_particles_reference

    jg = J.SlabGeometry.for_config(jcfg)
    pos, vel = init_particles_reference(jcfg.num_parts, jcfg.size, 42)
    slab, ovf = J.slab_from_particles(jnp.asarray(pos, jnp.float32),
                                      jnp.asarray(vel, jnp.float32), jg)
    assert int(ovf) == 0
    rng = np.random.default_rng(seed)
    xl, yl = np.array(slab.xl), np.array(slab.yl)
    live = np.asarray(slab.pid) >= 0
    bs = jg.bin_size
    xl[live] += rng.uniform(-frac * bs, frac * bs, live.sum()).astype(np.float32)
    yl[live] += rng.uniform(-frac * bs, frac * bs, live.sum()).astype(np.float32)
    return slab._replace(xl=jnp.asarray(xl), yl=jnp.asarray(yl))


@pytest.mark.parametrize("n,seed", [(1000, 0), (3000, 1)])
def test_pack_matches_jax(n, seed):
    """Same (bin, slot) for every particle: pid planes and overflow exact,
    bin-local positions allclose, velocities exact."""
    jcfg = JConfig(num_parts=n, grid_bin_scale=3.0, grid_capacity=8)
    jg, tg = _geoms(jcfg)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, jcfg.size, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    js, jov = J.slab_from_particles(jnp.asarray(pos), jnp.asarray(vel), jg)
    ts, tov = T.slab_from_particles(torch.from_numpy(pos), torch.from_numpy(vel), tg)
    np.testing.assert_array_equal(ts.pid.numpy(), np.asarray(js.pid))
    assert int(tov) == int(jov)
    for f in ("xl", "yl"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0, atol=1e-6)
    for f in ("vx", "vy"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


def test_pack_overflow_matches_jax():
    """An over-capacity bin keeps the lowest original indices and reports the
    same overflow in both packages."""
    jcfg = JConfig(num_parts=6, grid_capacity=2, grid_bin_scale=3.0)
    jg, tg = _geoms(jcfg)
    bs = jg.bin_size
    pos = np.array([[0.1 * bs, 0.1 * bs], [0.2 * bs, 0.2 * bs],
                    [0.3 * bs, 0.3 * bs], [0.4 * bs, 0.4 * bs],
                    [1.5 * bs, 0.5 * bs], [0.5 * bs, 1.5 * bs]], np.float32)
    vel = np.arange(12, dtype=np.float32).reshape(6, 2)
    js, jov = J.slab_from_particles(jnp.asarray(pos), jnp.asarray(vel), jg)
    ts, tov = T.slab_from_particles(torch.from_numpy(pos), torch.from_numpy(vel), tg)
    assert int(tov) == int(jov) == 2
    _assert_slab_equal(ts, js)
    assert set(ts.pid[ts.pid >= 0].tolist()) == {0, 1, 4, 5}


def test_slab_to_particles_roundtrip():
    jcfg = JConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6)
    jg, tg = _geoms(jcfg)
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, jcfg.size, (1000, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (1000, 2)).astype(np.float32)
    ts, tov = T.slab_from_particles(torch.from_numpy(pos), torch.from_numpy(vel), tg)
    assert int(tov) == 0
    p, v = T.slab_to_particles(ts, tg, 1000)
    np.testing.assert_allclose(p.numpy(), pos, atol=2e-6)
    np.testing.assert_array_equal(v.numpy(), vel)
    jp, jv = J.slab_to_particles(J.SlabState(*(jnp.asarray(t.numpy()) for t in ts)),
                                 jg, 1000)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_force_and_move_match_jax():
    """grid_force_xla + grid_move on a drifted slab with close pairs: same
    pair formula, same summation order; rsqrt and fusion differ in the last
    bits: positions to 1e-7, velocities to 1e-6 absolute or 2e-6 relative
    (close pairs give |a| dt up to ~1e2)."""
    jcfg = JConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                   evac_capacity=2, rebin_every=4)
    jslab = _drifted(jcfg, 0, 0.45)
    jg, tg = _geoms(jcfg)
    ts = _to_torch(jslab)
    c = jcfg
    jacc = J.grid_force_xla(jslab.xl, jslab.yl, jg, c.cutoff, c.min_r, c.mass)
    tacc = T.grid_force_xla(ts.xl, ts.yl, tg, c.cutoff, c.min_r, c.mass)
    assert float(np.abs(np.asarray(jacc[0])).max()) > 1.0  # pairs interact
    jnew, jms = J.grid_move(jslab, jacc, jg, c.dt, c.size)
    tnew, tms = T.grid_move(ts, tacc, tg, c.dt, c.size)
    np.testing.assert_array_equal(tnew.pid.numpy(), np.asarray(jnew.pid))
    for f, rtol, atol in (("xl", 0, 1e-7), ("yl", 0, 1e-7),
                          ("vx", 2e-6, 1e-6), ("vy", 2e-6, 1e-6)):
        np.testing.assert_allclose(getattr(tnew, f).numpy(),
                                   np.asarray(getattr(jnew, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    assert float(tms) == pytest.approx(float(jms), rel=1e-6)


def test_global_positions_and_dirs_match_jax():
    jcfg = JConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6)
    jslab = _drifted(jcfg, 1, 1.3)
    jg, tg = _geoms(jcfg)
    ts = _to_torch(jslab)
    for t, j in zip(T.global_positions(ts, tg), J.global_positions(jslab, jg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(T.slab_dirs(ts, tg), J.slab_dirs(jslab, jg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _mon(m):
    return [int(v) for v in m]


@pytest.mark.parametrize("case", ["drifted", "stress", "stress_far"])
def test_rebin_axes_bitwise_vs_jax(case):
    """grid_rebin_axes: all five planes and the monitors bitwise equal to the
    JAX twin, and K2's plain twin (count planes) to JAX's kernel call."""
    if case == "drifted":
        jcfg = JConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                       evac_capacity=2)
        jslab = _drifted(jcfg, 3, 0.6)
        jg, tg = _geoms(jcfg)
        evac = jcfg.evac_capacity
    else:
        jg = J.SlabGeometry(**STRESS)
        tg = T.SlabGeometry(**STRESS)
        jslab, _ = _stress_slab(jg, seed=0, far_movers=2 if case == "stress_far" else 0)
        evac = 2
    ts = _to_torch(jslab)
    jnew, jmon = jax.jit(lambda s: J.grid_rebin_axes(s, jg, evac))(jslab)
    tnew, tmon = T.grid_rebin_axes(ts, tg, evac)
    _assert_slab_equal(tnew, jnew)
    assert _mon(tmon) == _mon(jmon)
    assert int(tmon.deferred) > 0 or case == "drifted"
    pnew, cnt = rebin_axes_call_plain(ts, tg, evac)
    _assert_slab_equal(pnew, jnew)
    assert _mon(monitors_of_counts(cnt)) == _mon(jmon)


def test_rebin_axes_plain_matches_pallas_interpret_on_contention_slab():
    """K2's plain twin against the TPU kernel itself (interpret mode) on the
    contention slab: planes, count planes and monitors bitwise."""
    jg = J.SlabGeometry(**STRESS)
    tg = T.SlabGeometry(**STRESS)
    jslab, n = _stress_slab(jg, seed=0, far_movers=2)
    ts = _to_torch(jslab)
    jnew, jcnt = rebin_axes_call_pallas(jslab, jg, 2, interpret=True)
    tnew, tcnt = rebin_axes_call_cuda(ts, tg, 2)  # CPU tensors: the plain twin
    _assert_slab_equal(tnew, jnew)
    jcnt = np.asarray(jcnt).astype(np.int32)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    # grid_rebin_axes_pallas's reductions of the same planes
    jmon = [jcnt[2].max(), jcnt[1].sum() - jcnt[2].sum() + jcnt[0].sum(),
            jcnt[3].sum()]
    _, tmon = grid_rebin_axes_cuda(ts, tg, 2)
    assert _mon(tmon) == _mon(jmon)
    assert int(tmon.dropped) == 2
    pids = tnew.pid[tnew.pid >= 0]
    assert pids.numel() == n and torch.unique(pids).numel() == n


def test_shared_stress_slab_matches_jax_generator():
    """ppsim_tpu_torch.testing.stress_slab (used by chip_smoke.py and the card
    tests) draws the same slab as the JAX package's test generator."""
    from ppsim_tpu_torch.testing import STRESS_GEOMETRY, stress_slab

    assert dataclasses.asdict(STRESS_GEOMETRY) == STRESS
    jslab, _ = _stress_slab(J.SlabGeometry(**STRESS), seed=2, far_movers=2)
    _assert_slab_equal(stress_slab(STRESS_GEOMETRY, seed=2, far_movers=2), jslab)
