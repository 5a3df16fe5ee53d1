"""The shard forms of the port's kernels K1, K2, K7 and K8 (row offset and
ghost rows), through their plain twins on the CPU, against the JAX
package's shard forms of the TPU kernels in interpret mode
(``grid_step_pallas``, ``rebin_axes_call_pallas``, ``rebin_counts_pallas``,
``rebin_shuffle_pallas`` with ``row0`` and ghosts) on the same numpy
inputs, and against the rows of the single-device twin's output on the
whole slab. The ghosts of the port's side come through ``LocalMesh.halo``,
the engine's own transport; the JAX side's are cut with numpy.

Tolerances: the rebins and the count planes bitwise; the step, K1's
(rtol 1e-5, atol 1e-6: the TPU kernel sums each pair once, Newton 3, in
another order), and bitwise against the single-device twin's rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.pallas_grid import grid_step_pallas
from ppsim_tpu.ops.pallas_rebin import (
    rebin_axes_call_pallas, rebin_counts_pallas, rebin_shuffle_pallas,
)

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import shards_from_numpy, shards_to_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops.cuda_grid import grid_step_plain
from ppsim_tpu_torch.ops.cuda_rebin import (
    rebin_axes_call_plain, rebin_counts_plain, rebin_shuffle_plain,
)
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabState
from ppsim_tpu_torch.testing import SHARD_EDGE_GEOMETRY, shard_edge_slab

RTOL, ATOL = 1e-5, 1e-6
EVAC = 2
# 41 x 41 bins (rows padded to P strips of a multiple of 8), capacity 6:
# dense enough that pairs across every shard boundary meet inside the cutoff.
DENSE = SimConfig(num_parts=3000, grid_bin_scale=3.0, grid_capacity=6,
                  evac_capacity=2, rebin_every=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_halo(a, d, P, top_h, bot_h, fill):
    """Shard d's (top, bot) ghost blocks of the global array ``a``, cut with
    numpy (the edge shards get ``fill``)."""
    rl = a.shape[1] // P
    blank = lambda h: np.full((a.shape[0], h, a.shape[2]), fill, a.dtype)  # noqa: E731
    top = a[:, d * rl - top_h:d * rl] if d > 0 else blank(top_h)
    bot = a[:, (d + 1) * rl:(d + 1) * rl + bot_h] if d < P - 1 else blank(bot_h)
    return jnp.asarray(top), jnp.asarray(bot)


def _jgeom(tg):
    return J.SlabGeometry(**dataclasses.asdict(tg))


def _step_slab(P):
    """DENSE's packed init slab on the sharded engine's geometry (41 rows in
    P strips of a multiple of 8), live particles drifted by up to 0.3 bins
    (pairs meet inside the cutoff, none much closer than half of it: the
    drift of testing.step_slab), as numpy arrays."""
    eng = get_engine("sharded_grid", DENSE, device="cpu", shards=P)
    carry = eng.init_carry(init_particles(DENSE, seed=42))
    arrays = [a.copy() for a in shards_to_numpy(carry.slab)]
    rng = np.random.default_rng(5)
    live = arrays[4] >= 0
    bs = eng.geom.bin_size
    for k in (0, 1):
        arrays[k][live] += rng.uniform(-0.3 * bs, 0.3 * bs, live.sum()).astype(np.float32)
    return eng.geom, arrays


@pytest.mark.parametrize("P", [2, 4])
def test_step_shard_twin_matches_jax_shard_kernel(P):
    """K1's twin with row0 and ghost rows against grid_step_pallas(row0,
    ghosts) per shard, and against the single-device twin's rows."""
    geom, arrays = _step_slab(P)
    jg = _jgeom(geom)
    args = (DENSE.cutoff, DENSE.min_r, DENSE.mass, DENSE.dt, DENSE.size)
    shards = shards_from_numpy(*arrays, P)
    mesh = LocalMesh(P, "cpu")
    (gx, gy) = [mesh.halo([s[k] for s in shards], BIG, 1, 1) for k in (0, 1)]
    whole = grid_step_plain(*(torch.from_numpy(a) for a in arrays[:4]), geom, *args)
    rl = geom.rows_pad // P
    crossing = 0
    for d, s in enumerate(shards):
        tx, bx = gx[d]
        ty, by = gy[d]
        got = grid_step_plain(*s[:4], geom, *args, row0=d * rl, ghosts=(tx, ty, bx, by))
        jgh = [_np_halo(arrays[k], d, P, 1, 1, BIG) for k in (0, 1)]
        want = grid_step_pallas(
            *(jnp.asarray(a[:, d * rl:(d + 1) * rl]) for a in arrays[:4]), jg, *args,
            interpret=True, row0=d * rl,
            ghosts=(jgh[0][0], jgh[1][0], jgh[0][1], jgh[1][1]))
        for name, g, w, full in zip(("xl", "yl", "vx", "vy", "speed2"), got, want, whole):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} shard {d}")
            rows = full[:, d * rl:(d + 1) * rl] if full.dim() == 3 else full[d * rl:(d + 1) * rl]
            assert torch.equal(g, rows), f"{name} shard {d} vs the whole slab"
        # the ghost rows matter: without them the boundary rows' forces change
        alone = grid_step_plain(*s[:4], geom, *args, row0=d * rl)
        crossing += int((alone[2] != got[2]).sum())
    assert crossing > 0


def _rebin_shards(P, contention):
    geom = SHARD_EDGE_GEOMETRY
    slab = shard_edge_slab(geom, P, seed=P, contention=contention)
    arrays = [t.numpy() for t in slab]
    return geom, slab, arrays, shards_from_numpy(*arrays, P)


@pytest.mark.parametrize("P,contention", [(2, False), (4, True)],
                         ids=["P2", "P4-contention"])
def test_axes_rebin_shard_twin_matches_jax_shard_kernel(P, contention):
    """K2's twin with row0 and its ghost rows (1 above; 2 of xl and pid and 1
    of the others below) against rebin_axes_call_pallas(row0, field_ghosts),
    bitwise on the five planes and the count planes, and against the rows
    of the single-device twin."""
    geom, slab, arrays, shards = _rebin_shards(P, contention)
    jg = _jgeom(geom)
    mesh = LocalMesh(P, "cpu")
    halos = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 2 if k in (0, 4) else 1)
             for k in range(5)]
    whole, whole_cnt = rebin_axes_call_plain(slab, geom, EVAC)
    rl = geom.rows_pad // P
    moved = 0
    for d, s in enumerate(shards):
        got, cnt = rebin_axes_call_plain(s, geom, EVAC, row0=d * rl,
                                         field_ghosts=[h[d] for h in halos])
        jstate = J.SlabState(*(jnp.asarray(a[:, d * rl:(d + 1) * rl]) for a in arrays))
        jgh = [_np_halo(a, d, P, 1, 2 if k in (0, 4) else 1, SLAB_FILLS[k])
               for k, a in enumerate(arrays)]
        want, wcnt = rebin_axes_call_pallas(jstate, jg, EVAC, interpret=True,
                                            row0=d * rl, field_ghosts=jgh)
        for f, g, w, full in zip(SlabState._fields, got, want, whole):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{f} shard {d}")
            assert torch.equal(g, full[:, d * rl:(d + 1) * rl]), f"{f} shard {d}"
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt).astype(np.int32))
        assert torch.equal(cnt, whole_cnt[:, d * rl:(d + 1) * rl])
        moved += int((~torch.isin(got.pid[got.pid >= 0], s.pid[s.pid >= 0])).sum())
    assert moved > 0  # particles crossed shard boundaries
    assert int(whole_cnt[0].sum()) == 0 and int(whole_cnt[1].sum()) == int(whole_cnt[2].sum())
    if contention:
        assert int(whole_cnt[3].sum()) > 0  # movers deferred, none dropped


@pytest.mark.parametrize("P,contention", [(2, False), (4, True)],
                         ids=["P2", "P4-contention"])
def test_dirs9_shard_twins_match_jax_shard_kernels(P, contention):
    """K7's twin with row0 and K8's with 1 field ghost row and 2 count ghost
    rows each side against rebin_counts_pallas(row0) and
    rebin_shuffle_pallas(row0, field_ghosts, count_ghosts), bitwise, and
    against the rows of the single-device twins."""
    geom, slab, arrays, shards = _rebin_shards(P, contention)
    jg = _jgeom(geom)
    mesh = LocalMesh(P, "cpu")
    whole_counts = rebin_counts_plain(slab, geom)
    whole, whole_cnt = rebin_shuffle_plain(slab, whole_counts, geom, EVAC)
    rl = geom.rows_pad // P
    counts = [rebin_counts_plain(s, geom, row0=d * rl) for d, s in enumerate(shards)]
    fh = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 1) for k in range(5)]
    ch = mesh.halo(counts, 0, 2, 2)
    jcounts_all = []
    for d, s in enumerate(shards):
        jstate = J.SlabState(*(jnp.asarray(a[:, d * rl:(d + 1) * rl]) for a in arrays))
        jc = rebin_counts_pallas(jstate, jg, interpret=True, row0=d * rl)
        np.testing.assert_array_equal(counts[d].numpy(), np.asarray(jc).astype(np.int32))
        assert torch.equal(counts[d], whole_counts[:, d * rl:(d + 1) * rl])
        jcounts_all.append(np.asarray(jc))
    jcounts = np.concatenate(jcounts_all, axis=1)
    moved = 0
    for d, s in enumerate(shards):
        got, cnt = rebin_shuffle_plain(s, counts[d], geom, EVAC, row0=d * rl,
                                       field_ghosts=[h[d] for h in fh],
                                       count_ghosts=ch[d])
        jstate = J.SlabState(*(jnp.asarray(a[:, d * rl:(d + 1) * rl]) for a in arrays))
        want = rebin_shuffle_pallas(
            jstate, jnp.asarray(jcounts[:, d * rl:(d + 1) * rl]), jg, EVAC,
            interpret=True, row0=d * rl,
            field_ghosts=[_np_halo(a, d, P, 1, 1, SLAB_FILLS[k]) for k, a in enumerate(arrays)],
            count_ghosts=_np_halo(jcounts, d, P, 2, 2, 0.0))
        for f, g, w, full in zip(SlabState._fields, got, want, whole):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{f} shard {d}")
            assert torch.equal(g, full[:, d * rl:(d + 1) * rl]), f"{f} shard {d}"
        assert torch.equal(cnt, whole_cnt[:, d * rl:(d + 1) * rl])
        moved += int((~torch.isin(got.pid[got.pid >= 0], s.pid[s.pid >= 0])).sum())
    assert moved > 0
    assert int(whole_cnt[1].sum()) == int(whole_cnt[2].sum())  # nothing dropped
    if contention:
        assert int(whole_cnt[3].sum()) > 0


def test_shard_forms_refuse_half_the_ghosts():
    """K8's shard form takes its field and count ghosts together."""
    geom, slab, _, shards = _rebin_shards(2, False)
    counts = rebin_counts_plain(shards[0], geom)
    fh = LocalMesh(2, "cpu").halo([s.xl for s in shards], BIG, 1, 1)
    with pytest.raises(ValueError, match="together"):
        rebin_shuffle_plain(shards[0], counts, geom, EVAC,
                            field_ghosts=[fh[0]] * 5)
