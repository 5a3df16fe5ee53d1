"""The tiled step kernels (K1 + K6 ``csrc/grid_step.cu``, K3
``csrc/grid3_step.cu``) on the CPU: their launch plan for every geometry the
port's choosers produce, and their plain twins against the JAX package on
the slabs the tiled data path is sensitive to (holes left by rebins, a bin
filled to capacity, edge bins beside the padding). The kernels themselves
are held to these twins on the card (tests/test_torch_kernels.py,
chip_smoke.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.engines.grid3d import _coef_of as jcoef_of
from ppsim_tpu.ops import grid3d_ops as J3
from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.physics import lj_coef_from_r2 as jlj_coef_from_r2

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.ops.cuda_grid import (
    MAX_CAP, SMEM_LIMIT, TILE_THREADS, grid_force_plain, grid_step_plain, step_plan,
    tile_smem,
)
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_plain, step3_plan
from ppsim_tpu_torch.ops.grid3d_ops import Geometry3S
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry
from ppsim_tpu_torch.testing import (
    STEP_SLAB_KINDS, STRESS_GEOMETRY, STRESS_GEOMETRY3, step_slab,
)

# Positions and velocities after one step, against the JAX XLA twins: the
# same summation order, last bits from fusion (as tests/test_torch_step.py).
RTOL, ATOL = 1e-5, 1e-6
# Accelerations (K6's twin): close pairs' terms cancel, so 1e-6 of the
# largest |a| absolute, as K6 is held on the card.
ACC_ATOL_OF_MAX = 1e-6
LJ = dict(force_law="lj", dt=1e-4)
# 41 x 41 bins padded to 48 x 128, capacity 6; and the 3D BASE3 test config
# (6^3 bins padded to 6 x 8 x 128, capacity 8). At n = 472 the 3D box fills
# its last bins (5^3 padded to 5 x 8 x 128), so particles sit beside the
# padding.
TINY2 = dict(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6, evac_capacity=2,
             rebin_every=4)
TINY3 = dict(num_parts=500, ndim=3, density=7e-6, grid3_capacity=8, evac_capacity=2,
             rebin3_every=4)
EDGE3 = dict(TINY3, num_parts=472)
STRETCH = dict(num_parts=20_971_520, ndim=3, density=7e-6, force_law="lj", dt=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shape2(**kw):
    return SlabGeometry.for_config(SimConfig(**kw)).shape


def _shape3(**kw):
    return Geometry3S.for_config(SimConfig(**kw)).shape


PLAN_SHAPES = {
    "2d-main": (14, 1664, 1664),
    "2d-cli-padded": _shape2(num_parts=262_144),
    "2d-tiny": _shape2(num_parts=200, grid_bin_scale=3.0, grid_capacity=6),
    "2d-tiny-3000": _shape2(**TINY2),
    "2d-stress": STRESS_GEOMETRY.shape,
    "2d-main-cap32": (32, 1664, 1664),
    "3d-stretch": _shape3(**STRETCH),
    "3d-cli-padded": _shape3(num_parts=262_144, ndim=3, density=7e-6),
    "3d-tiny": _shape3(**TINY3),
    "3d-stress": STRESS_GEOMETRY3.shape,
    "3d-stretch-cap32": (32, 140, 152, 256),
}


def _plan_boxes(plan, extents):
    """The bins each block of ``plan`` owns, in the kernels' block order
    (``blockIdx.x``: tiles of the last axis fastest, then the middle axis,
    then the walked segment): an int array (blocks, ndim, 2) of [lo, hi)
    per axis, axes in slab order ((R, C) or (Y, X, Z)), cut at ``extents``."""
    tile = (plan.seg, *plan.tile)
    counts = [-(-e // t) for e, t in zip(extents, tile)]
    idx = np.indices(counts).reshape(len(counts), -1).T
    lo = idx * np.asarray(tile)
    hi = np.minimum(lo + np.asarray(tile), np.asarray(extents))
    return np.stack([lo, hi], axis=-1)


def test_plan_shapes_are_the_choosers():
    assert PLAN_SHAPES["2d-cli-padded"] == (11, 232, 256)
    assert PLAN_SHAPES["3d-stretch"] == (13, 140, 152, 256)
    assert PLAN_SHAPES["3d-cli-padded"] == (10, 41, 48, 128)


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_step_plan_covers_every_bin_once(name):
    """The plan's blocks cover every bin of the array exactly once, each
    block's halo (its tile grown by one bin, cut at the mask) stays inside
    the array and fits the kernel's buffers, and the block's shared memory
    fits a Hopper block."""
    shape = PLAN_SHAPES[name]
    cap, extents = shape[0], shape[1:]
    three = len(extents) == 3
    plan = step3_plan(shape) if three else step_plan(shape)
    tile = (plan.seg, *plan.tile)
    halo_bins = int(np.prod([t + 2 for t in plan.tile]))
    own_bins = int(np.prod(plan.tile))
    assert plan.smem == tile_smem(len(extents), cap, halo_bins, own_bins)
    assert plan.smem <= SMEM_LIMIT
    assert plan.threads % 32 == 0 and plan.threads <= TILE_THREADS
    # the kernels' copy map needs a thread per halo bin; a particle-list
    # entry holds the own bin in 11 bits and the slot in 5
    assert halo_bins <= plan.threads and own_bins <= 2048 and cap <= MAX_CAP
    boxes = _plan_boxes(plan, extents)
    assert boxes.shape == (plan.blocks, len(extents), 2)
    cover = np.zeros(extents, np.int32)
    for box in boxes:
        lo, hi = box[:, 0], box[:, 1]
        assert np.all(lo < hi) and np.all(hi - lo <= np.asarray(tile))
        cover[tuple(slice(a, b) for a, b in box)] += 1
        # the halo a block copies: the walked axis through the ring (one
        # row or slab each side), the others through the halo columns
        h_lo = np.maximum(lo - 1, 0)
        h_hi = np.minimum(hi + 1, np.asarray(extents))
        assert np.all(h_hi - h_lo <= np.asarray(tile) + 2)
        assert np.all(h_lo >= 0) and np.all(h_hi <= np.asarray(extents))
    assert cover.min() == 1 and cover.max() == 1
    # the walk fills the card several times over at the full-width shapes
    if np.prod(extents) >= 1_000_000:
        assert plan.blocks >= 4 * 132


@functools.lru_cache(maxsize=None)
def _jax_step2(jg, cutoff, min_r, mass, dt, size, law, law_params):
    pair_fn = None
    if law == "lj":
        eps, sigma = law_params

        def pair_fn(dx, dy):
            coef = jlj_coef_from_r2(dx * dx + dy * dy, cutoff, min_r, mass, eps, sigma)
            return coef * dx, coef * dy

    @jax.jit
    def step(slab):
        acc = J.grid_force_xla(slab.xl, slab.yl, jg, cutoff, min_r, mass, pair_fn=pair_fn)
        return acc, J.grid_move(slab, acc, jg, dt, size)
    return step


@functools.lru_cache(maxsize=None)
def _jax_step3(jg, jcfg):
    @jax.jit
    def step(slab):
        acc = J3.grid3_force_xla(slab.xl, slab.yl, slab.zl, jg, jcoef_of(jcfg))
        return acc, J3.grid3_move(slab, acc, jg, jcfg.dt, jcfg.size)
    return step


def _check_kind(kind, geom, pid):
    """The slab has what its kind promises."""
    live = pid >= 0
    count = live.sum(axis=0)
    if kind == "holey":
        assert int((~live[:-1] & live[1:]).sum()) > 0  # a hole below a live slot
    elif kind == "full":
        assert int(count.max()) == geom.capacity
    else:
        if pid.ndim == 3:  # 2D: rows and columns padded
            assert geom.rows_pad > geom.rows and geom.cols_pad > geom.cols
            assert live[:, geom.rows - 1].any() and live[:, :, geom.cols - 1].any()
        else:
            assert geom.xs_pad > geom.xs and geom.zs_pad > geom.zs
            assert live[:, :, geom.xs - 1].any() and live[:, :, :, geom.zs - 1].any()


@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("kind", STEP_SLAB_KINDS)
def test_step_twins_match_jax_on_sensitive_slabs_2d(kind, law):
    """K1's and K6's plain twins against the JAX XLA twin (grid_force_xla +
    grid_move) on a holey, a full and an edge slab, with both laws."""
    cfg = SimConfig(**TINY2, **(LJ if law == "lj" else {}))
    geom, slab = step_slab(cfg, kind)
    arrays = [t.numpy() for t in slab]
    _check_kind(kind, geom, arrays[4])
    jg = J.SlabGeometry(**dataclasses.asdict(geom))
    jstep = _jax_step2(jg, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size, law,
                       tuple(cfg.law_params))
    jacc, (jnew, jms) = jstep(J.SlabState(*(jnp.asarray(a) for a in arrays)))
    args = (geom, cfg.cutoff, cfg.min_r, cfg.mass)
    acc = grid_force_plain(*slab[:2], *args, law, cfg.law_params)
    scale = float(np.abs(np.asarray(jacc[0])).max())
    assert scale > 1.0  # forces act
    for name, t, j in zip(("ax", "ay"), acc, jacc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ACC_ATOL_OF_MAX * scale, err_msg=name)
    got = grid_step_plain(*slab[:4], *args, cfg.dt, cfg.size, law, cfg.law_params)
    for name, t, j in zip(("xl", "yl", "vx", "vy"), got, jnew):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert float(torch.sqrt(got[4].max())) == pytest.approx(float(jms), rel=1e-6)


@pytest.mark.parametrize("law", ["repulsive", "lj"])
@pytest.mark.parametrize("kind", STEP_SLAB_KINDS)
def test_step_twin_matches_jax_on_sensitive_slabs_3d(kind, law):
    """K3's plain twin against the JAX XLA twin (grid3_force_xla +
    grid3_move) on a holey, a full and an edge slab, with both laws."""
    kw = dict(EDGE3, **(LJ if law == "lj" else {}))
    cfg, jcfg = SimConfig(**kw), JConfig(**kw)
    geom, slab = step_slab(cfg, kind)
    arrays = [t.numpy() for t in slab]
    _check_kind(kind, geom, arrays[6])
    jg = J3.Geometry3S(**dataclasses.asdict(geom))
    jacc, (jnew, jms) = _jax_step3(jg, jcfg)(J3.Slab3State(*(jnp.asarray(a) for a in arrays)))
    assert float(np.abs(np.asarray(jacc[0])).max()) > 1.0  # forces act
    got = grid3_step_plain(*slab[:6], geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt,
                           cfg.size, law, cfg.law_params)
    for name, t, j in zip(("xl", "yl", "zl", "vx", "vy", "vz"), got, jnew):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert float(torch.sqrt(got[6].max())) == pytest.approx(float(jms), rel=1e-6)
