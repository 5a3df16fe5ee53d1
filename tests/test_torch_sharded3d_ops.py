"""The shard forms of the port's 3D kernels K3, K4 and K5 (y offset and
ghost y slabs), through their plain twins on the CPU:

- K3's twin with ``y0`` and ghost slabs against the JAX package's shard form
  of the TPU kernel in interpret mode (``grid3_step_pallas`` with ``y0`` and
  ``ghosts``) on the same numpy inputs, and against the rows of the
  single-device twin's output on the whole slab;
- K4's twin with ``y0`` and K5's with ``y0`` and its field and count ghosts
  against the route the JAX package holds its 3D shard kernels to
  (``grid3_rebin_axes`` on the strip extended by two ghost slabs a side,
  with ``y0 - 2``, interior kept: ``engines/sharded_grid3d.py:208-257``),
  against the rows of the single-device twins' outputs, and against the
  JAX package's shard route of the TPU kernels themselves in interpret mode
  (``rebin3_inplane_pallas`` then ``rebin3_ypass_pallas`` on that
  extension with ``y0 - 2``; one shape, ~17 s of compiles).

The ghosts of the port's side come through ``LocalMesh.halo``, the engine's
own transport; the JAX side's are cut with numpy.

Tolerances: K4, K5 and their count planes bitwise; K3 at rtol 1e-5, atol
1e-6 against the JAX kernel (it sums the top ghost slab's pairs self-side
only and the rest by Newton 3, in another order), and bitwise against the
single-device twin's rows (a particle's sum does not depend on the split).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.ops import grid3d_ops as J
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.pallas_grid3d import grid3_step_pallas
from ppsim_tpu.ops.pallas_rebin3 import rebin3_inplane_pallas, rebin3_ypass_pallas

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import shards3_from_numpy, shards_to_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_plain
from ppsim_tpu_torch.ops.cuda_rebin3 import (
    rebin3_inplane_plain, rebin3_ypass_plain,
)
from ppsim_tpu_torch.ops.grid3d_ops import FILLS3, Slab3State
from ppsim_tpu_torch.testing import SHARD_EDGE_GEOMETRY3, shard_edge_slab3

RTOL, ATOL = 1e-5, 1e-6
EVAC = 2
# The JAX package's 3D test config at n = 200: 4 x 4 x 4 bins, capacity 8,
# in y strips of max(2, ceil(4 / P)) = 2 slabs at P = 2 and 4, so one
# compile of the JAX kernel in interpret mode (~40 s of CPU) serves both.
CFG3 = SimConfig(num_parts=200, ndim=3, density=7e-6, grid3_capacity=8,
                 evac_capacity=2, rebin3_every=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_halo(a, d, P, top_h, bot_h, fill):
    """Shard d's (top, bot) ghost blocks of the global array ``a`` along
    dim 1, cut with numpy (the edge shards get ``fill``)."""
    yl = a.shape[1] // P
    blank = lambda h: np.full((a.shape[0], h, *a.shape[2:]), fill, a.dtype)  # noqa: E731
    top = a[:, d * yl - top_h:d * yl] if d > 0 else blank(top_h)
    bot = a[:, (d + 1) * yl:(d + 1) * yl + bot_h] if d < P - 1 else blank(bot_h)
    return top, bot


def _jgeom(tg):
    return J.Geometry3S(**dataclasses.asdict(tg))


def _step_slab(P):
    """CFG3's packed init slab on the sharded engine's geometry, live
    particles drifted by up to 0.2 bins on every axis (pairs meet inside
    the cutoff across every boundary, the closest near half of it: the
    drift of testing.step_slab), as numpy arrays."""
    eng = get_engine("sharded_grid3d", CFG3, device="cpu", shards=P)
    carry = eng.init_carry(init_particles(CFG3, seed=42, method="fast"))
    arrays = [a.copy() for a in shards_to_numpy(carry.slab)]
    rng = np.random.default_rng(5)
    live = arrays[6] >= 0
    g = eng.geom
    for k, bs in enumerate((g.bsx, g.bsy, g.bsz)):
        arrays[k][live] += rng.uniform(-0.2 * bs, 0.2 * bs, live.sum()).astype(np.float32)
    return g, eng.ys_local, arrays


@pytest.mark.parametrize("P", [2, 4])
def test_step3_shard_twin_matches_jax_shard_kernel(P):
    """K3's twin with y0 and ghost slabs against grid3_step_pallas(y0,
    ghosts) per shard, and against the single-device twin's rows."""
    geom, yl, arrays = _step_slab(P)
    jg = _jgeom(geom)
    args = (CFG3.cutoff, CFG3.min_r, CFG3.mass, CFG3.dt, CFG3.size)
    shards = shards3_from_numpy(*arrays, P)
    halos = [LocalMesh(P, "cpu").halo([s[k] for s in shards], BIG, 1, 1) for k in range(3)]
    whole = grid3_step_plain(*(torch.from_numpy(a) for a in arrays[:6]), geom, *args)
    # the JAX kernel reads no y extent of its geometry: one static geometry
    # for every P keeps its compile cache
    jg = dataclasses.replace(jg, ys_pad=jg.ys)
    crossing = 0
    for d, s in enumerate(shards):
        ghosts = tuple(h[d][0] for h in halos) + tuple(h[d][1] for h in halos)
        got = grid3_step_plain(*s[:6], geom, *args, y0=d * yl, ghosts=ghosts)
        jgh = [_np_halo(arrays[k], d, P, 1, 1, BIG) for k in range(3)]
        want = grid3_step_pallas(
            *(jnp.asarray(a[:, d * yl:(d + 1) * yl]) for a in arrays[:6]), jg, *args,
            interpret=True, y0=jnp.int32(d * yl),
            ghosts=tuple(jnp.asarray(t) for t, _ in jgh) + tuple(jnp.asarray(b) for _, b in jgh))
        for name, g, w, full in zip(("xl", "yl", "zl", "vx", "vy", "vz", "speed2"),
                                    got, want, whole):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} shard {d}")
            rows = full[:, d * yl:(d + 1) * yl] if full.dim() == 4 else full[d * yl:(d + 1) * yl]
            assert torch.equal(g, rows), f"{name} shard {d} vs the whole slab"
        # the ghost slabs matter: without them the boundary slabs' forces change
        alone = grid3_step_plain(*s[:6], geom, *args, y0=d * yl)
        crossing += int((alone[3] != got[3]).sum())
    assert crossing > 0


def _rebin_shards(P, contention):
    geom = SHARD_EDGE_GEOMETRY3
    slab = shard_edge_slab3(geom, P, seed=P, contention=contention)
    arrays = [t.numpy() for t in slab]
    return geom, slab, arrays, shards3_from_numpy(*arrays, P)


@pytest.mark.parametrize("P,contention", [(2, False), (4, True)],
                         ids=["P2", "P4-contention"])
def test_rebin3_shard_twins_match_jax_shard_route(P, contention):
    """K4's twin with y0, then K5's with y0, one field ghost slab a side and
    the count ghosts (1 slab above, 2 below) of K4's output, bitwise against
    the JAX grid3_rebin_axes on the 2-slab extension with y0 - 2 (interior
    kept), and against the rows of the single-device twins."""
    geom, slab, arrays, shards = _rebin_shards(P, contention)
    jg = _jgeom(geom)
    mesh = LocalMesh(P, "cpu")
    yl = geom.ys_pad // P
    wmid, wcnt = rebin3_inplane_plain(slab, geom, EVAC)
    whole, wpost = rebin3_ypass_plain(wmid, wcnt, geom, EVAC)
    mids = []
    for d, s in enumerate(shards):
        mid, cnt = rebin3_inplane_plain(s, geom, EVAC, y0=d * yl)
        for k, (g, w) in enumerate(zip((*mid, cnt), (*wmid, wcnt))):
            assert torch.equal(g, w[:, d * yl:(d + 1) * yl]), f"K4 output {k} shard {d}"
        mids.append((mid, cnt))
    fh = [mesh.halo([m[k] for m, _ in mids], FILLS3[k], 1, 1) for k in range(7)]
    ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
    jrebin = jax.jit(lambda s, y0: J.grid3_rebin_axes(s, jg, EVAC, y0=y0)[0])
    moved = 0
    for d, ((mid, cnt), s) in enumerate(zip(mids, shards)):
        got, post = rebin3_ypass_plain(mid, cnt, geom, EVAC, y0=d * yl,
                                       field_ghosts=[h[d] for h in fh],
                                       count_ghosts=ch[d])
        ext = J.Slab3State(*(
            jnp.asarray(np.concatenate([t, a[:, d * yl:(d + 1) * yl], b], axis=1))
            for a, fill in zip(arrays, FILLS3)
            for t, b in [_np_halo(a, d, P, 2, 2, fill)]))
        want = jrebin(ext, jnp.int32(d * yl - 2))
        for f, g, w, full in zip(Slab3State._fields, got, want, whole):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 2:-2],
                                          err_msg=f"{f} shard {d}")
            assert torch.equal(g, full[:, d * yl:(d + 1) * yl]), f"{f} shard {d}"
        assert torch.equal(post, wpost[:, d * yl:(d + 1) * yl])
        moved += int((~torch.isin(got.pid[got.pid >= 0], s.pid[s.pid >= 0])).sum())
    assert moved > 0  # particles crossed shard boundaries
    # nothing dropped: as many alive after as before, no far movers
    assert int(wcnt[3].sum()) == 0 and int(wcnt[4].sum()) == int(wpost[0].sum())
    if contention:
        assert int(wpost[1].sum()) > 0  # movers deferred, none dropped


def test_rebin3_shard_twins_match_jax_shard_kernels():
    """K4's and K5's shard twins against the JAX package's TPU kernels in
    interpret mode on the 2-slab extension with y0 - 2 (the JAX engine's
    Pallas route), interior kept: outputs, K4's count planes and K5's post
    planes bitwise, on the contention form of the shard-edge slab in 4
    strips."""
    P = 4
    geom, _, arrays, shards = _rebin_shards(P, True)
    jg = _jgeom(geom)
    mesh = LocalMesh(P, "cpu")
    yl = geom.ys_pad // P
    mids = [rebin3_inplane_plain(s, geom, EVAC, y0=d * yl) for d, s in enumerate(shards)]
    fh = [mesh.halo([m[k] for m, _ in mids], FILLS3[k], 1, 1) for k in range(7)]
    ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
    for d, (mid, cnt) in enumerate(mids):
        got, post = rebin3_ypass_plain(mid, cnt, geom, EVAC, y0=d * yl,
                                       field_ghosts=[h[d] for h in fh],
                                       count_ghosts=ch[d])
        ext = J.Slab3State(*(
            jnp.asarray(np.concatenate([t, a[:, d * yl:(d + 1) * yl], b], axis=1))
            for a, fill in zip(arrays, FILLS3)
            for t, b in [_np_halo(a, d, P, 2, 2, fill)]))
        y0 = jnp.int32(d * yl - 2)
        jmid, jcnt = rebin3_inplane_pallas(ext, jg, EVAC, interpret=True, y0=y0)
        jout, jpost = rebin3_ypass_pallas(jmid, jcnt, jg, EVAC, interpret=True, y0=y0)
        for k, (g, w) in enumerate(zip((*mid, cnt), (*jmid, jcnt))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 2:-2].astype(g.numpy().dtype),
                                          err_msg=f"K4 output {k} shard {d}")
        for k, (g, w) in enumerate(zip((*got, post), (*jout, jpost))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 2:-2].astype(g.numpy().dtype),
                                          err_msg=f"K5 output {k} shard {d}")


def test_shard_forms_refuse_half_the_ghosts():
    """K3's shard form takes all six ghost planes; K5's its field and count
    ghosts together."""
    geom, slab, _, shards = _rebin_shards(2, False)
    s = shards[0]
    ghost = torch.full((geom.capacity, 1, geom.xs_pad, geom.zs_pad), BIG)
    with pytest.raises(ValueError, match="6 ghost planes"):
        grid3_step_plain(*s[:6], geom, CFG3.cutoff, CFG3.min_r, CFG3.mass, CFG3.dt,
                         CFG3.size, ghosts=(ghost,) * 3)
    mid, cnt = rebin3_inplane_plain(s, geom, EVAC)
    fh = LocalMesh(2, "cpu").halo([m.xl for m in (mid, mid)], BIG, 1, 1)
    with pytest.raises(ValueError, match="together"):
        rebin3_ypass_plain(mid, cnt, geom, EVAC, field_ghosts=[fh[0]] * 7)
