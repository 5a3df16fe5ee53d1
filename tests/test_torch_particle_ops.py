"""Port parity of the particle-list engines' ops against the JAX package on
identical numpy inputs: the bin ids, the capacity-padded grid (slot
positions, slot ids, counts and the overflow monitor, with a full bin and
the sharded engine's transit bin), the 3x3 stencil forces with both laws,
and the ND force-law closures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu import physics as JP
from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.ops import binning as JB
from ppsim_tpu.ops.forces import stencil_accel as jstencil_accel

from ppsim_tpu_torch import physics as TP
from ppsim_tpu_torch.convert import config_from_dict
from ppsim_tpu_torch.ops import binning as TB
from ppsim_tpu_torch.ops.forces import STENCIL, stencil_accel

# JAX's jit rewrites the repulsive law's cutoff / sqrt(r2) into cutoff *
# rsqrt(r2), which XLA's CPU backend does not round correctly; the port
# divides by torch.sqrt, as the JAX package's eager ops and the native oracle
# do. So a pair term may differ by an ulp or two, and sums of terms that
# cancel carry it: accelerations agree to 1e-5 relative, and to 1e-6 of the
# largest |a| absolute (the bound of K6's parity, chip_smoke.py).
ACC_RTOL, ACC_ATOL_OF_MAX = 1e-5, 1e-6

N = 1500


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_config(**kw):
    return JConfig(num_parts=N, **kw)


def _positions(jcfg, seed, crowd=0):
    """(N, 2) float32 positions uniform in the box from a numpy seed, the
    first ``crowd`` of them in one bin near the box's centre (a full bin)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, jcfg.size, (N, 2)).astype(np.float32)
    if crowd:
        c = (jcfg.bins_per_side // 2 + 0.5) * jcfg.bin_size
        pos[:crowd] = c + rng.uniform(-0.4, 0.4, (crowd, 2)) * jcfg.bin_size
    return pos


def _jax_grid(pos, jgeom, transit=0):
    """The JAX sort + grid on ``pos``; the last ``transit`` particles get
    the sharded engine's transit bin (num_bins + 1)."""
    _, _, bid = JB.bin_ids_of(jnp.asarray(pos), jgeom)
    if transit:
        bid = bid.at[-transit:].set(jgeom.num_bins + 1)
    order, sid, rank = JB.sort_by_bin(bid)
    jpos = jnp.asarray(pos)[order]
    return bid, order, sid, jpos, JB.build_grid(jpos, sid, rank, jgeom)


@pytest.mark.parametrize("crowd,transit", [(0, 0), (12, 0), (12, 40)],
                         ids=["plain", "full-bin", "full-bin+transit"])
def test_build_grid_matches_jax(crowd, transit):
    """Same bin ids, sort order and ranks, and the same grid bitwise: slot
    positions, slot ids, counts and max_count; a bin of 12 or more at
    capacity 8 leaves its excess out of the grid, and transit-bin particles
    stay out of it."""
    jcfg = _jax_config()
    jgeom = JB.GridGeometry.square(jcfg)
    tgeom = TB.GridGeometry.square(config_from_dict(dataclasses.asdict(jcfg)))
    assert dataclasses.asdict(tgeom) == dataclasses.asdict(jgeom)
    pos = _positions(jcfg, seed=3, crowd=crowd)
    jbid, jorder, jsid, _, jgrid = _jax_grid(pos, jgeom, transit)

    tpos = torch.from_numpy(pos)
    r, c, tbid = TB.bin_ids_of(tpos, tgeom)
    jr, jc, _ = JB.bin_ids_of(jnp.asarray(pos), jgeom)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    if transit:
        tbid[-transit:] = tgeom.num_bins + 1
    np.testing.assert_array_equal(tbid.numpy(), np.asarray(jbid))
    order, sid, rank = TB.sort_by_bin(tbid)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    tgrid = TB.build_grid(tpos[order], sid, rank, tgeom)
    for f in jgrid._fields:
        np.testing.assert_array_equal(getattr(tgrid, f).numpy(),
                                      np.asarray(getattr(jgrid, f)), err_msg=f)
    cap = tgeom.capacity
    assert (int(tgrid.max_count) > cap) == bool(crowd)
    over = int(torch.clamp(tgrid.counts - cap, min=0).sum())
    assert int((tgrid.slot_gid >= 0).sum()) == N - transit - over


@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_stencil_accel_matches_jax(law):
    """The 3x3 stencil on the same grid: accelerations within the stated
    tolerance, exactly zero for the same particles, and the brute-force sum
    over all pairs (the oracle's formulation) in the port."""
    kw = dict(force_law="lj", lj_sigma=0.004) if law == "lj" else {}
    jcfg = _jax_config(**kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jgeom = JB.GridGeometry.square(jcfg)
    tgeom = TB.GridGeometry.square(tcfg)
    pos = _positions(jcfg, seed=5, crowd=6)
    _, _, jsid, jpos, jgrid = _jax_grid(pos, jgeom)
    jrow = jsid // jgeom.ncols
    jacc = np.asarray(jax.jit(lambda p, r, c, s: jstencil_accel(
        p, r, c, s, jgeom, jcfg.cutoff, jcfg.min_r, jcfg.mass,
        pair_fn=JP.accel_fn_for(jcfg)))(jpos, jrow, jsid - jrow * jgeom.ncols,
                                        jgrid.slot_pos))

    order, sid, rank = TB.sort_by_bin(TB.bin_ids_of(torch.from_numpy(pos), tgeom)[2])
    tpos = torch.from_numpy(pos)[order]
    tgrid = TB.build_grid(tpos, sid, rank, tgeom)
    row = sid // tgeom.ncols
    tacc = stencil_accel(tpos, row, sid - row * tgeom.ncols, tgrid.slot_pos, tgeom,
                         tcfg.cutoff, tcfg.min_r, tcfg.mass,
                         pair_fn=TP.accel_fn_for(tcfg)).numpy()
    assert np.abs(tacc).max() > 0  # the crowded bin interacts
    np.testing.assert_array_equal(tacc == 0, jacc == 0)
    np.testing.assert_allclose(tacc, jacc, rtol=ACC_RTOL,
                               atol=ACC_ATOL_OF_MAX * np.abs(jacc).max())

    # every pair in range is in the stencil: the oracle's all-pairs sum
    # (another summation order, so within the tolerance: the crowded bin
    # gives particles more than two terms)
    from ppsim_tpu_torch.engines.oracle import all_pairs_accel

    np.testing.assert_allclose(all_pairs_accel(tpos, TP.accel_fn_for(tcfg)).numpy(), tacc,
                               rtol=ACC_RTOL, atol=ACC_ATOL_OF_MAX * np.abs(tacc).max())


def test_stencil_order_is_jax_order():
    from ppsim_tpu.ops.forces import STENCIL as JSTENCIL

    assert STENCIL == JSTENCIL


@pytest.mark.parametrize("law,ndim", [("repulsive", 2), ("repulsive", 3), ("lj", 3)])
def test_accel_vec_fn_matches_jax(law, ndim):
    """The ND force-law closure on the same displacements: equal to the
    port's (dx, dy) law in 2D bitwise, and to JAX's closure (eager ops)
    within the stated tolerance."""
    jcfg = JConfig(num_parts=100, ndim=ndim, force_law=law)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    d = rng.uniform(-0.012, 0.012, (4000, ndim)).astype(np.float32)
    got = TP.accel_vec_fn_for(tcfg)(torch.from_numpy(d)).numpy()
    want = np.asarray(JP.accel_vec_fn_for(jcfg)(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=ACC_RTOL,
                               atol=ACC_ATOL_OF_MAX * np.abs(want).max())
    if ndim == 2 and law == "repulsive":
        ax, ay = TP.accel_fn_for(tcfg)(torch.from_numpy(d[:, 0]), torch.from_numpy(d[:, 1]))
        np.testing.assert_array_equal(got, torch.stack([ax, ay], -1).numpy())
        pa = TP.pair_accel(torch.zeros(2), torch.from_numpy(d), tcfg.cutoff,
                           tcfg.min_r, tcfg.mass).numpy()
        np.testing.assert_array_equal(pa, got)
        jpa = np.asarray(JP.pair_accel(jnp.zeros(2), jnp.asarray(d), jcfg.cutoff,
                                       jcfg.min_r, jcfg.mass))
        np.testing.assert_allclose(pa, jpa, rtol=ACC_RTOL,
                                   atol=ACC_ATOL_OF_MAX * np.abs(jpa).max())
