"""The strip-walking rebin kernels (K2 ``csrc/rebin_axes.cu``, K4
``csrc/rebin3.cu``, both ``csrc/rebin_tile.cuh``; the dirs9 shuffle K8
``csrc/rebin_dirs9.cu``) on the CPU: their launch plans for every geometry
the port's choosers produce and at capacity 32, and their plain twins (K7's
too) against the JAX package on the slab whose contention sits where the
kernels' blocks meet (``testing.rebin_edge_slab``). The kernels themselves
are held to these twins on the card (tests/test_torch_kernels.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.ops import grid3d_ops as J3
from ppsim_tpu.ops import grid_ops as J

from ppsim_tpu_torch.ops.cuda_grid import MAX_CAP, SMEM_LIMIT, SMEM_TWO_BLOCKS, TILE_THREADS
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_plain, rebin_counts_plain, rebin_plan, rebin_shuffle_plain, rebin_smem,
    shuffle_plan, shuffle_smem,
)
from ppsim_tpu_torch.ops.cuda_rebin3 import (
    FAR_PRE, ALIVE_PRE, rebin3_inplane_plain, rebin3_plan, rebin3_ypass_plain,
)
from ppsim_tpu_torch.ops.grid3d_ops import rebin3_monitors
from ppsim_tpu_torch.ops.grid_ops import monitors_of_counts
from ppsim_tpu_torch.testing import (
    REBIN_EDGE_GEOMETRY, REBIN_EDGE_GEOMETRY3, rebin_edge_slab,
)

from test_torch_step_plan import PLAN_SHAPES

REBIN_PLAN_SHAPES = dict(
    PLAN_SHAPES,
    **{"2d-edge": REBIN_EDGE_GEOMETRY.shape, "3d-edge": REBIN_EDGE_GEOMETRY3.shape,
       "2d-ragged-cap32": (32, 21, 150), "3d-ragged-cap32": (32, 3, 19, 70)})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain twins run many small ops: under the suite's parallel
    workers, torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks(plan, extents):
    """The bins each block of a fused-rebin ``plan`` owns, in the kernel's
    block order (``blockIdx.x``: strips fastest, then segments of the walked
    axis, then y-slabs in 3D): an int array (blocks, ndim, 2) of [lo, hi)
    per array axis ((R, C) or (Y, X, Z)), cut at ``extents``."""
    t, seg = plan.tile[0], plan.seg
    *lead, W, S = extents
    boxes = []
    for y in range(lead[0] if lead else 1):
        for wa in range(0, W, seg):
            for s0 in range(0, S, t):
                box = [[wa, min(W, wa + seg)], [s0, min(S, s0 + t)]]
                boxes.append(([[y, y + 1]] if lead else []) + box)
    return np.asarray(boxes)


def test_rebin_plan_shapes_cover_both_tiles():
    """The main path's K2 strips are 32 columns, the stretch config's K4
    strips 32 z-bins; capacity 32 narrows both to 16."""
    assert rebin_plan(PLAN_SHAPES["2d-main"]).tile == (32,)
    assert rebin3_plan(PLAN_SHAPES["3d-stretch"]).tile == (32,)
    assert rebin_plan(PLAN_SHAPES["2d-main-cap32"]).tile == (16,)
    assert rebin3_plan(PLAN_SHAPES["3d-stretch-cap32"]).tile == (16,)


# (shape name, kernel): K2 / K4 ("rebin") at every shape, K8 ("shuffle") at
# the 2D ones.
PLAN_CASES = [pytest.param(name, "rebin", id=name) for name in sorted(REBIN_PLAN_SHAPES)] + [
    pytest.param(name, "shuffle", id=f"{name}-shuffle")
    for name in sorted(REBIN_PLAN_SHAPES) if len(REBIN_PLAN_SHAPES[name]) == 3]


@pytest.mark.parametrize("name,kernel", PLAN_CASES)
def test_rebin_plan_covers_every_bin_once(name, kernel):
    """The plan's blocks cover every bin of the array exactly once; each
    block's halo fits its buffers (K2 / K4: one bin before the strip and two
    after, the ring's rows one before the segment and two after; K8: fields
    one bin and counts two bins each side, along both axes); the shared
    memory repeats the kernel's layout and fits a Hopper block; the block
    count is the strip/segment arithmetic the entry point checks."""
    shape = REBIN_PLAN_SHAPES[name]
    cap, extents = shape[0], shape[1:]
    three = len(extents) == 3
    shuffle = kernel == "shuffle"
    plan = shuffle_plan(shape) if shuffle else rebin3_plan(shape) if three else rebin_plan(shape)
    t, seg = plan.tile[0], plan.seg
    *lead, W, S = extents
    before, after = (2, 2) if shuffle else (1, 2)
    assert plan.smem == (shuffle_smem(cap, t) if shuffle
                         else rebin_smem(7 if three else 5, cap, t))
    assert plan.smem <= SMEM_LIMIT
    assert plan.threads % 32 == 0 and plan.threads <= TILE_THREADS
    # a thread per halo bin takes its masks (K8: a thread per own bin and
    # direction settles it); slot indices fit 5 bits
    assert t + before + after <= plan.threads and cap <= MAX_CAP
    assert not shuffle or 8 * t <= plan.threads
    assert plan.blocks == -(-S // t) * -(-W // seg) * (lead[0] if lead else 1)
    boxes = _blocks(plan, extents)
    assert boxes.shape == (plan.blocks, len(extents), 2)
    cover = np.zeros(extents, np.int32)
    for box in boxes:
        lo, hi = box[:, 0], box[:, 1]
        assert np.all(lo < hi)
        assert hi[-1] - lo[-1] <= t and hi[-2] - lo[-2] <= seg
        cover[tuple(slice(a, b) for a, b in box)] += 1
        # the halo the block reads, cut at the array: strip bins and rows
        # from `before` bins before to `after` after; the strip's fits the
        # buffers' halo bins
        h_lo = np.maximum(lo[-2:] - before, 0)
        h_hi = np.minimum(hi[-2:] + after, np.asarray(extents[-2:]))
        assert h_hi[1] - h_lo[1] <= t + before + after
        assert np.all(h_lo >= 0) and np.all(h_hi <= np.asarray(extents[-2:]))
    assert cover.min() == 1 and cover.max() == 1
    # the walk fills the card several times over at the full-width shapes
    if np.prod(extents) >= 1_000_000:
        assert plan.blocks >= 4 * 132


def _edge_case(dim, evac):
    geom = REBIN_EDGE_GEOMETRY if dim == "2d" else REBIN_EDGE_GEOMETRY3
    plan = rebin_plan(geom.shape) if dim == "2d" else rebin3_plan(geom.shape)
    return geom, plan, rebin_edge_slab(geom, plan, seed=evac)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_rebin_edge_slab_has_its_contention(dim):
    """Full bins on both sides of a strip edge and of a segment edge, a
    one-slot bin beside them, and movers out of the edge bins both ways
    along both pass axes."""
    geom, plan, slab = _edge_case(dim, 2)
    pid = slab.pid.numpy()
    occ = (pid >= 0).sum(axis=0)
    cap, t, seg = geom.capacity, plan.tile[0], plan.seg
    strip_edge = occ[..., t - 1:t + 1]
    walk_edge = occ[..., seg - 1:seg + 1, :]
    assert (strip_edge == cap).all(axis=-1).any() and (walk_edge == cap).all(axis=-2).any()
    assert (occ[..., t - 2] == cap - 1).any() and (occ[..., seg + 1, :] == cap - 1).any()
    coords = (slab.xl, slab.yl) if dim == "2d" else (slab.xl, slab.zl)
    sides = (geom.bin_size,) * 2 if dim == "2d" else (geom.bsx, geom.bsz)
    live = pid[..., t - 1:t + 1] >= 0
    for c, bs in zip(coords, sides):
        d = np.floor(c.numpy()[..., t - 1:t + 1][live] / bs)
        assert (d < 0).any() and (d > 0).any()


@pytest.mark.parametrize("evac", [2, 3])
def test_rebin_twin_matches_jax_on_edge_slab_2d(evac):
    """K2's plain twin against the JAX package's grid_rebin_axes on the edge
    slab: all five planes and the monitors exactly equal."""
    geom, _, slab = _edge_case("2d", evac)
    jg = J.SlabGeometry(**dataclasses.asdict(geom))
    jslab = J.SlabState(*(jnp.asarray(t.numpy()) for t in slab))
    jnew, jmon = jax.jit(lambda s: J.grid_rebin_axes(s, jg, evac))(jslab)
    new, cnt = rebin_axes_call_plain(slab, geom, evac)
    for name, t, j in zip(jnew._fields, new, jnew):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    mon = [int(v) for v in monitors_of_counts(cnt)]
    assert mon == [int(v) for v in jmon]
    assert mon[2] > 0  # contention left movers behind
    assert int((new.pid != slab.pid).sum()) > 100


@pytest.mark.parametrize("evac", [2, 3])
def test_rebin_twins_match_jax_on_edge_slab_3d(evac):
    """K4's and K5's plain twins against the JAX package's grid3_rebin_axes
    on the edge slab: all seven planes and the monitors exactly equal."""
    geom, _, slab = _edge_case("3d", evac)
    jg = J3.Geometry3S(**dataclasses.asdict(geom))
    jslab = J3.Slab3State(*(jnp.asarray(t.numpy()) for t in slab))
    jnew, jmon = jax.jit(lambda s: J3.grid3_rebin_axes(s, jg, evac))(jslab)
    mid, counts = rebin3_inplane_plain(slab, geom, evac)
    new, post = rebin3_ypass_plain(mid, counts, geom, evac)
    for name, t, j in zip(jnew._fields, new, jnew):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    mon = [int(v) for v in rebin3_monitors(counts[FAR_PRE], counts[ALIVE_PRE], post)]
    assert mon == [int(v) for v in jmon]
    assert mon[2] > 0
    assert int((new.pid != slab.pid).sum()) > 100


def test_shuffle_plan_strips_and_shared_bytes():
    """K8's strips are 32 columns wherever a block of 32 leaves room for two
    on an SM and 16 elsewhere, for every capacity the kernels take; the
    shared bytes are the kernel's layout (shuffle_smem) and fit a Hopper
    block; at the main path's capacity 14 a block leaves room for three on
    an SM (228 KB less 1 KB a block)."""
    for cap in range(1, MAX_CAP + 1):
        plan = shuffle_plan((cap, 1664, 1664))
        want = 32 if shuffle_smem(cap, 32) <= SMEM_TWO_BLOCKS else 16
        assert plan.tile == (want,)
        assert plan.smem == shuffle_smem(cap, want) <= SMEM_LIMIT
    assert shuffle_plan(REBIN_PLAN_SHAPES["2d-main"]).tile == (32,)
    assert 3 * (shuffle_plan(REBIN_PLAN_SHAPES["2d-main"]).smem + 1024) <= 228 * 1024
    # the layout grows with every slot and every strip column
    assert shuffle_smem(14, 32) < shuffle_smem(15, 32)
    assert shuffle_smem(14, 16) < shuffle_smem(14, 32)


def _jax_monitor_planes(jslab, jnew, jg):
    """The int32 (4, R, C) monitor stack [far_pre, alive_pre, alive_post,
    resid] of a dirs9 rebin from jslab to jnew, from the JAX package's
    slab_dirs (resid: live slots of jnew still pointing out of their bin,
    as grid_rebin_pallas's monitors count them)."""
    _, _, far0, alive0 = J.slab_dirs(jslab, jg)
    dx2, dy2, _, alive2 = J.slab_dirs(jnew, jg)
    resid = np.asarray(alive2) & ((np.asarray(dx2) != 0) | (np.asarray(dy2) != 0))
    return np.stack([np.asarray(far0).sum(0), np.asarray(alive0).sum(0),
                     np.asarray(alive2).sum(0), resid.sum(0)]).astype(np.int32)


@pytest.mark.parametrize("evac", [1, 2])
def test_dirs9_twins_match_jax_on_edge_slab(evac):
    """K7's and K8's plain twins against the JAX package's rebin_counts and
    grid_rebin (XLA) on the strip-edge slab of K8's plan: the count stack,
    all five planes and the monitor stack exactly equal."""
    geom = REBIN_EDGE_GEOMETRY
    slab = rebin_edge_slab(geom, shuffle_plan(geom.shape), seed=10 + evac)
    jg = J.SlabGeometry(**dataclasses.asdict(geom))
    jslab = J.SlabState(*(jnp.asarray(t.numpy()) for t in slab))
    jcounts, _ = J.rebin_counts(jslab, jg)
    jnew, jmon = jax.jit(lambda s: J.grid_rebin(s, jg, evac))(jslab)
    counts = rebin_counts_plain(slab, geom)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int32))
    new, cnt = rebin_shuffle_plain(slab, counts, geom, evac)
    for name, t, j in zip(jnew._fields, new, jnew):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    np.testing.assert_array_equal(cnt.numpy(), _jax_monitor_planes(jslab, jnew, jg))
    mon = [int(v) for v in monitors_of_counts(cnt)]
    assert mon[:2] == [int(v) for v in jmon][:2]
    assert int(jmon.deferred) > 0 and mon[2] > 0  # contention left movers behind
    assert int((new.pid != slab.pid).sum()) > 100
