"""Port parity of the 3D slab grid (``ppsim_tpu_torch.ops.grid3d_ops`` and the
plain twins of K3-K5) against the JAX package's ``ppsim_tpu.ops.grid3d_ops``:
the same numpy inputs through both. The JAX side runs its XLA twins, which
is how its own fast tests hold the 3D Pallas kernels (the interpret tests
are slow); the kernels are held against the port's twins on the card
(tests/test_torch_kernels.py, chip_smoke.py). Also the 3D checker and the
3D initializer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu import checker as jchecker
from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines.grid3d import Grid3DEngine as JGrid3DEngine
from ppsim_tpu.engines.grid3d import _coef_of as jcoef_of
from ppsim_tpu.initlib import init_particles as jinit_particles
from ppsim_tpu.ops import grid3d_ops as J

from ppsim_tpu_torch import checker as tchecker
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import config_from_dict, slab3_state_from_numpy
from ppsim_tpu_torch.engines.grid3d import _coef_of as tcoef_of
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops import grid3d_ops as T
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_plain
from ppsim_tpu_torch.ops.cuda_rebin3 import rebin3_inplane_plain, rebin3_ypass_plain

BASE3 = dict(ndim=3, density=7e-6, grid3_capacity=8, evac_capacity=2,
             rebin3_every=4)
LJ = dict(force_law="lj", dt=1e-4)
# Both force twins sum in the same order; the JAX XLA graph may fuse or
# reassociate the last bits, and accelerations reach ~1e4 in close pairs.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tgeom(jg) -> T.Geometry3S:
    return T.Geometry3S(**dataclasses.asdict(jg))


def _numpy_init(jcfg, seed=42):
    pos, vel = jinit_particles(jcfg, seed=seed, method="fast")
    return np.asarray(pos), np.asarray(vel)


def _drifted(jcfg, frac, seed):
    """JAX-packed slab of the fast init, live particles drifted by up to
    ``frac`` bins on every axis (numpy arrays, for both packages). At 0.2 the
    closest pair sits near 0.6 cutoff, as in a run that passes the checker;
    much closer pairs make the force sums cancel to a few ulps of their
    terms, which no two summation codes agree on."""
    jg = J.Geometry3S.for_config(jcfg)
    pos, vel = _numpy_init(jcfg)
    slab, ovf = J.slab3_from_particles(jnp.asarray(pos), jnp.asarray(vel), jg)
    assert int(ovf) == 0
    arrays = [np.array(a) for a in slab]
    rng = np.random.default_rng(seed)
    live = arrays[6] >= 0
    for k, bs in enumerate((jg.bsx, jg.bsy, jg.bsz)):
        arrays[k][live] += rng.uniform(-frac * bs, frac * bs,
                                       live.sum()).astype(np.float32)
    return jg, arrays


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("n", [500, 1_048_576, 4_194_304, 20_971_520])
def test_geometry3s_equals_jax(n, law, snap):
    kw = dict(ndim=3, density=7e-6, grid3_snap_lanes=snap,
              **(LJ if law == "lj" else {}))
    jg = J.Geometry3S.for_config(JConfig(num_parts=n, **kw))
    cfg = SimConfig(num_parts=n, **kw)
    tg = T.Geometry3S.for_config(cfg)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert tg.cadence(cfg) == jg.cadence(JConfig(num_parts=n, **kw))
    assert tg.shape == jg.shape
    if n == 20_971_520 and law == "lj" and snap:  # the stretch config
        assert (tg.ys, tg.xs, tg.zs, tg.capacity, tg.cadence(cfg)) == (
            140, 152, 256, 13, 8)


@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_pack_and_gather_match_jax(law):
    jcfg = JConfig(num_parts=500, **BASE3, **(LJ if law == "lj" else {}))
    jg = J.Geometry3S.for_config(jcfg)
    pos, vel = _numpy_init(jcfg)
    jslab, jovf = J.slab3_from_particles(jnp.asarray(pos), jnp.asarray(vel), jg)
    tslab, tovf = T.slab3_from_particles(torch.from_numpy(pos),
                                         torch.from_numpy(vel), _tgeom(jg))
    assert int(tovf) == int(jovf) == 0
    np.testing.assert_array_equal(tslab.pid.numpy(), np.asarray(jslab.pid))
    for k in range(6):
        np.testing.assert_allclose(tslab[k].numpy(), np.asarray(jslab[k]),
                                   rtol=0, atol=1e-7)
    # gather round-trips to the input (positions within an ulp of the box)
    tpos, tvel = T.slab3_to_particles(tslab, _tgeom(jg), 500)
    jpos, jvel = J.slab3_to_particles(jslab, jg, 500)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tvel.numpy(), vel)
    np.testing.assert_allclose(tpos.numpy(), pos, rtol=0, atol=1e-6)
    # an under-capacity pack reports its overflow like the JAX one
    small = dataclasses.replace(jg, capacity=2)
    _, jovf = J.slab3_from_particles(jnp.asarray(pos), jnp.asarray(vel), small)
    _, tovf = T.slab3_from_particles(torch.from_numpy(pos),
                                     torch.from_numpy(vel), _tgeom(small))
    assert int(tovf) == int(jovf) > 0


def _spill_inputs():
    """The JAX package's spill scenario (tests/test_3d_grid.py): 8 particles
    on a 2x2x2 grid at capacity 2, bin (0,0,0) one past it, and a variant
    whose receiver has room for only one of two donors."""
    pos = np.array([
        [0.005, 0.005, 0.005], [0.012, 0.012, 0.012],
        [0.0295, 0.015, 0.015], [0.035, 0.005, 0.005],
        [0.005, 0.035, 0.005], [0.005, 0.005, 0.035],
        [0.035, 0.035, 0.005], [0.035, 0.035, 0.035]], np.float32)
    multi = np.array([
        [0.005, 0.005, 0.005], [0.012, 0.012, 0.012],
        [0.0295, 0.008, 0.020], [0.0296, 0.020, 0.008],
        [0.035, 0.008, 0.008], [0.005, 0.005, 0.035],
        [0.035, 0.035, 0.005], [0.035, 0.035, 0.035]], np.float32)
    return pos, multi


def test_spill_pack_matches_jax():
    jcfg = JConfig(num_parts=8, ndim=3, density=7e-6, grid3_capacity=2,
                   rebin3_every=1, grid3_spill=True)
    jeng = JGrid3DEngine(jcfg)
    jg, depth = jeng.geom, jeng._spill_depth()
    for pos in _spill_inputs():
        vel = 0.05 * np.arange(24, dtype=np.float32).reshape(8, 3) - 0.5
        js, jovf, jsp = J.slab3_from_particles_spill(
            jnp.asarray(pos), jnp.asarray(vel), jg, depth)
        ts, tovf, tsp = T.slab3_from_particles_spill(
            torch.from_numpy(pos), torch.from_numpy(vel), _tgeom(jg), depth)
        assert (int(tovf), int(tsp)) == (int(jovf), int(jsp))
        for t, j in zip(ts, js):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (int(tovf), int(tsp)) == (1, 2)  # the collision case


@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_force_and_move_match_jax(law):
    jcfg = JConfig(num_parts=500, **BASE3, **(LJ if law == "lj" else {}))
    jg, arrays = _drifted(jcfg, 0.2, 1)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tg = _tgeom(jg)
    jslab = J.Slab3State(*(jnp.asarray(a) for a in arrays))
    tslab = slab3_state_from_numpy(*arrays)

    @jax.jit
    def jstep(s):
        acc = J.grid3_force_xla(s.xl, s.yl, s.zl, jg, jcoef_of(jcfg))
        return acc, J.grid3_move(s, acc, jg, jcfg.dt, jcfg.size)

    jacc, (jnew, jms) = jstep(jslab)
    tacc = T.grid3_force_xla(tslab.xl, tslab.yl, tslab.zl, tg, tcoef_of(tcfg))
    tnew, tms = T.grid3_move(tslab, tacc, tg, tcfg.dt, tcfg.size)
    assert float(np.abs(np.asarray(jacc[0])).max()) > 1.0  # forces act
    # an acceleration that cancels to ~1 from terms of ~1e4 keeps only a
    # few ulps of its terms, so the raw sums agree to 1e-4; the state after
    # the move (a * dt) is held at the stated tolerance
    for name, t, j in zip("xyz", tacc, jacc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4, err_msg=f"a{name}")
    for name, t, j in zip(tnew._fields, tnew, jnew):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(tms) == pytest.approx(float(jms), rel=1e-6)
    # K3's plain twin (the kernels' pair arithmetic, sentinel aliveness)
    got = grid3_step_plain(*tslab[:6], tg, tcfg.cutoff, tcfg.min_r, tcfg.mass,
                           tcfg.dt, tcfg.size, law, tcfg.law_params)
    for name, t, j in zip(tnew._fields[:6], got, jnew):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=f"plain twin {name}")
    assert float(torch.sqrt(got[6].max())) == pytest.approx(float(jms), rel=1e-6)


def test_rebin_matches_jax_exactly():
    jcfg = JConfig(num_parts=500, **BASE3)
    jg, arrays = _drifted(jcfg, 0.8, 2)
    tg = _tgeom(jg)
    jnew, jmon = jax.jit(lambda s: J.grid3_rebin_axes(s, jg, 2))(
        J.Slab3State(*(jnp.asarray(a) for a in arrays)))
    tslab = slab3_state_from_numpy(*arrays)
    tnew, tmon = T.grid3_rebin_axes(tslab, tg, 2)
    assert int((tnew.pid != tslab.pid).sum()) > 100  # movers moved
    for name, t, j in zip(tnew._fields, tnew, jnew):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert [int(v) for v in tmon] == [int(v) for v in jmon]
    # K4 then K5 (their plain twins) compose to the same rebin
    mid, counts = rebin3_inplane_plain(tslab, tg, 2)
    out, post = rebin3_ypass_plain(mid, counts, tg, 2)
    for t, o in zip(tnew, out):
        assert torch.equal(t, o)
    mon = T.rebin3_monitors(counts[3], counts[4], post)
    assert [int(v) for v in mon] == [int(v) for v in jmon]


@pytest.mark.parametrize("n", [3000, 30_000])
def test_checker3_matches_jax(n):
    """absmin/absavg of 3D frames: the brute-force pass (n <= 20,000) and
    the numpy cell-list pass, against the JAX checker on the same frames."""
    rng = np.random.default_rng(n)
    side = (7e-6 * n) ** (1 / 3)
    frames = rng.uniform(0, side, (2, n, 3))
    frames[:, :50] = frames[:, 50:100] + rng.uniform(-0.004, 0.004, (2, 50, 3))
    for f in frames:
        t = tchecker.frame_distance_stats(f, 0.01, use_native=False)
        j = jchecker.frame_distance_stats(f, 0.01, use_native=False)
        assert t[2] == j[2] > 0
        assert t[0] == j[0] and t[1] == pytest.approx(j[1], rel=1e-12)
    cfg = SimConfig(num_parts=n, ndim=3, density=7e-6)
    jcfg = JConfig(num_parts=n, ndim=3, density=7e-6)
    t, j = tchecker.check_frames(frames, cfg), jchecker.check_frames(frames, jcfg)
    assert (t.absmin, t.passed) == (j.absmin, j.passed)
    assert t.absavg == pytest.approx(j.absavg, rel=1e-12)


def test_init3_lattice_and_permutation():
    """The 3D fast init is the JAX package's lattice: ceil(N^(1/3))^2 x sz
    cells, each particle on its own cell, velocities in [-1, 1); seeded."""
    cfg = SimConfig(num_parts=1000, ndim=3, density=7e-6)
    st = init_particles(cfg, seed=7, method="fast")
    pos, vel = st.pos.numpy(), st.vel.numpy()
    assert pos.shape == vel.shape == (1000, 3) and pos.dtype == np.float32
    jpos, _ = _numpy_init(JConfig(num_parts=1000, ndim=3, density=7e-6), 7)
    # the same lattice sites to an ulp (the permutation differs: torch vs
    # jax.random)
    np.testing.assert_allclose(np.unique(pos, axis=0), np.unique(jpos, axis=0),
                               rtol=2e-7)
    assert len(np.unique(pos, axis=0)) == 1000
    assert pos.min() > 0 and pos.max() < cfg.size
    assert vel.min() >= -1.0 and vel.max() < 1.0
    again = init_particles(cfg, seed=7, method="fast")
    assert torch.equal(again.pos, st.pos) and torch.equal(again.vel, st.vel)
    other = init_particles(cfg, seed=8, method="fast")
    assert not torch.equal(other.pos, st.pos)
    with pytest.raises(ValueError, match="2D-only"):
        init_particles(cfg, seed=7, method="reference")
