"""The tile forms of the port's K1 and K2 (a row and a column offset, ghost
rows and ghost columns with their corners), through their plain twins on
the CPU, against the JAX package's tile route on the same numpy inputs:

- the plain ops' ``col0`` (``grid_move``, ``slab_dirs``, ``grid_rebin_axes``,
  ``grid_rebin``) against the JAX ops on offset tiles;
- K2's twin against the JAX ghost-ring route (``grid_rebin_axes`` on the
  tile extended by 2 bins a side, ``row0 - 2``, ``col0 - 2``) on every tile
  of a 2 x 2 and a contended 1 x 4 mesh, and against the rows and columns of
  the single-device twin's output on the whole slab; and once against the
  JAX kernel ``rebin_axes_call_pallas(col0=...)`` in interpret mode on the
  JAX package's column-extended arrays, ghost lanes sliced off;
- K1's twin on every tile against the single-device twin's bins, and once
  against ``grid_step_pallas(col0=...)`` in interpret mode;
- the 2-D ``LocalMesh``: corner bins and the split / gather round trip.

The ghosts of the port's side come through ``LocalMesh.tile_halo``, the
engine's own transport; the JAX side's are cut with numpy. Tolerances: the
rebins and the count planes bitwise; K1 against the JAX kernel at rtol
1e-5, atol 1e-6 (the TPU kernel sums each pair once, Newton 3, in another
order), and bitwise against the single-device twin's bins; the move
against the JAX ops as tests/test_torch_grid_ops.py holds it (positions
1e-7, velocities 2e-6 relative or 1e-6 absolute: XLA may fuse the update).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.pallas_grid import grid_step_pallas
from ppsim_tpu.ops.pallas_rebin import rebin_axes_call_pallas

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.convert import tiles_from_numpy, tiles_to_numpy
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.engines.mesh import LocalMesh
from ppsim_tpu_torch.engines.sharded_tile import ring_extend
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.ops import grid_ops as T
from ppsim_tpu_torch.ops.cuda_grid import grid_step_plain
from ppsim_tpu_torch.ops.cuda_rebin import rebin_axes_call_plain
from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabState
from ppsim_tpu_torch.testing import TILE_EDGE_GEOMETRY, tile_edge_slab

RTOL, ATOL = 1e-5, 1e-6
EVAC = 2
# grid_test_config (tests/conftest.py): 24 x 24 bins, capacity 6; on a 2 x 2
# mesh with col_block 8, tiles of 16 x 16 (rows and columns padded to 32).
GRID_TEST = SimConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                      evac_capacity=2, rebin_every=4)
# The JAX pallas route's ghost-lane block at col_block 8, and its real ghost
# columns: 1 for the step, 2 for the rebin (sharded_tile.py:134, 233, 301).
LANES = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jgeom(tg, **kw):
    return J.SlabGeometry(**{**dataclasses.asdict(tg), **kw})


def _cut(a, shape, d):
    """Tile d's (row slice, col slice) and its (row0, col0) in ``a``."""
    pr, pc = shape
    rl, cl = a.shape[1] // pr, a.shape[2] // pc
    r, c = divmod(d, pc)
    return slice(r * rl, (r + 1) * rl), slice(c * cl, (c + 1) * cl), r * rl, c * cl


def _np_ring(a, shape, d, h, fill):
    """Tile d of ``a`` extended by ``h`` bins a side, the neighbours' bins
    where there are tiles, ``fill`` beyond the mesh (numpy: the JAX
    ``_extend2``)."""
    pr, pc = shape
    rl, cl = a.shape[1] // pr, a.shape[2] // pc
    r, c = divmod(d, pc)
    padded = np.full((a.shape[0], a.shape[1] + 2 * h, a.shape[2] + 2 * h), fill, a.dtype)
    padded[:, h:-h, h:-h] = a
    out = padded[:, r * rl:(r + 1) * rl + 2 * h, c * cl:(c + 1) * cl + 2 * h].copy()
    if r == 0:
        out[:, :h] = fill
    if r == pr - 1:
        out[:, -h:] = fill
    if c == 0:
        out[:, :, :h] = fill
    if c == pc - 1:
        out[:, :, -h:] = fill
    return out


def _np_lane_ext(a, shape, r_lo, r_hi, c, w, fill):
    """The JAX pallas route's column-extended block of tile column ``c`` over
    global rows r_lo..r_hi-1: a LANES-wide ``fill`` block each side whose
    inner ``w`` lanes hold the lateral tiles' boundary columns
    (``_col_extend``); rows outside the array are ``fill``."""
    pc = shape[1]
    cl = a.shape[2] // pc
    rows = np.arange(r_lo, r_hi)
    inside = (rows >= 0) & (rows < a.shape[1])
    out = np.full((a.shape[0], len(rows), cl + 2 * LANES), fill, a.dtype)
    src = a[:, rows[inside]]
    out[:, inside, LANES:LANES + cl] = src[:, :, c * cl:(c + 1) * cl]
    if c > 0:
        out[:, inside, LANES - w:LANES] = src[:, :, c * cl - w:c * cl]
    if c < pc - 1:
        out[:, inside, LANES + cl:LANES + cl + w] = src[:, :, (c + 1) * cl:(c + 1) * cl + w]
    return out


def _np_lane_tile(a, shape, d, w, fill, top_h, bot_h):
    """Tile d on the JAX pallas route: the column-extended tile and its ghost
    rows, cut from the column-extended neighbours (corners included; the
    edge tiles get ``fill``)."""
    pr, _ = shape
    rl = a.shape[1] // pr
    r, c = divmod(d, shape[1])
    tile = _np_lane_ext(a, shape, r * rl, (r + 1) * rl, c, w, fill)
    top = _np_lane_ext(a, shape, r * rl - top_h, r * rl, c, w, fill)
    bot = _np_lane_ext(a, shape, (r + 1) * rl, (r + 1) * rl + bot_h, c, w, fill)
    if r == 0:
        top[:] = fill
    if r == pr - 1:
        bot[:] = fill
    return tile, top, bot


def _moved(tiles, out):
    """Live pids of ``out`` that were not in the tile before (arrivals)."""
    return sum(int((~torch.isin(o.pid[o.pid >= 0], t.pid[t.pid >= 0])).sum())
               for t, o in zip(tiles, out))


# ---------------------------------------------------------------- plain ops
def test_plain_ops_col0_match_jax_on_offset_tiles():
    """grid_move and slab_dirs with row0 and col0 on each tile of a 2 x 2
    mesh, and grid_rebin_axes and grid_rebin on the 2-bin ring extension of
    the two tiles with one offset 0 and the other not: the port's ops against
    the JAX ops (the move within its tolerance, the rest bitwise), and the
    move bitwise against the whole slab's bins. The slab puts particles up
    to a bin beyond the east and west walls, so the wall fold takes the
    global column."""
    geom = TILE_EDGE_GEOMETRY
    shape = (2, 2)
    size = 1.34  # 27 columns of 0.05: the wall lies inside the last column
    arrays = [t.numpy() for t in tile_edge_slab(geom, shape, seed=3)]
    rng = np.random.default_rng(4)
    acc = [rng.normal(size=geom.shape).astype(np.float32) * 50 for _ in range(2)]
    dt = 5e-4
    whole, _ = T.grid_move(SlabState(*(torch.from_numpy(a) for a in arrays)),
                           [torch.from_numpy(a) for a in acc], geom, dt, size)
    jg = _jgeom(geom)
    folded = 0
    for d in range(4):
        rs, cs, r0, c0 = _cut(arrays[0], shape, d)
        tile = [a[:, rs, cs] for a in arrays]
        ts = SlabState(*(torch.from_numpy(np.ascontiguousarray(a)) for a in tile))
        js = J.SlabState(*(jnp.asarray(a) for a in tile))
        tacc = [torch.from_numpy(np.ascontiguousarray(a[:, rs, cs])) for a in acc]
        tnew, tms = T.grid_move(ts, tacc, geom, dt, size, row0=r0, col0=c0)
        jnew, jms = J.grid_move(js, [jnp.asarray(a[:, rs, cs]) for a in acc], jg, dt, size,
                                row0=r0, col0=c0)
        for f, rtol, atol in (("xl", 0, 1e-7), ("yl", 0, 1e-7),
                              ("vx", 2e-6, 1e-6), ("vy", 2e-6, 1e-6)):
            np.testing.assert_allclose(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                       rtol=rtol, atol=atol, err_msg=f"{f} tile {d}")
            assert torch.equal(getattr(tnew, f), getattr(whole, f)[:, rs, cs]), (f, d)
        assert float(tms) == pytest.approx(float(jms), rel=1e-6)
        folded += int((tnew.yl != ts.yl + tnew.vy * np.float32(dt)).sum())
        for t, j in zip(T.slab_dirs(ts, geom, r0, c0), J.slab_dirs(js, jg, r0, c0)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"dirs tile {d}")
        if d not in (1, 2):
            continue
        ext = [_np_ring(a, shape, d, 2, fill) for a, fill in zip(arrays, SLAB_FILLS)]
        text = SlabState(*(torch.from_numpy(a) for a in ext))
        jext = J.SlabState(*(jnp.asarray(a) for a in ext))
        for tfn, jfn in ((T.grid_rebin_axes, J.grid_rebin_axes), (T.grid_rebin, J.grid_rebin)):
            tn, tm = tfn(text, geom, EVAC, row0=r0 - 2, col0=c0 - 2)
            jn, jm = jfn(jext, jg, EVAC, row0=r0 - 2, col0=c0 - 2)
            for f, t, j in zip(SlabState._fields, tn, jn):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=f"{tfn.__name__} {f} tile {d}")
            assert [int(v) for v in tm] == [int(v) for v in jm], (tfn.__name__, d)
    assert folded > 0  # the wall fold ran on offset tiles


# --------------------------------------------------------------------- K2
def _edge_tiles(shape, contention, seed):
    geom = TILE_EDGE_GEOMETRY
    slab = tile_edge_slab(geom, shape, seed=seed, contention=contention)
    arrays = [t.numpy() for t in slab]
    return geom, slab, arrays, tiles_from_numpy(*arrays, shape)


def _k2_ghosts(mesh, tiles):
    """K2's ghosts of every tile through the mesh: 1 row above, 2 of xl and
    pid and 1 of the others below, 1 column west and 2 east."""
    halos = [mesh.tile_halo([t[k] for t in tiles], SLAB_FILLS[k], 1,
                            2 if k in (0, 4) else 1, 1, 2) for k in range(5)]
    return ([[h[d][:2] for h in halos] for d in range(len(tiles))],
            [[h[d][2:] for h in halos] for d in range(len(tiles))])


@pytest.mark.parametrize("shape,contention", [((2, 2), False), ((1, 4), True)],
                         ids=["2x2", "1x4-contention"])
def test_axes_rebin_tile_twin_matches_jax_ring_route(shape, contention):
    """K2's twin with row0, col0 and its ghost rows and columns on every
    tile against the JAX engine's ring route (grid_rebin_axes on the 2-bin
    ring extension) and against the single-device twin's bins, bitwise on
    the five planes and the count planes; particles cross tile boundaries,
    and with contention movers are deferred, none dropped."""
    geom, slab, arrays, tiles = _edge_tiles(shape, contention, seed=7)
    jg = _jgeom(geom)
    mesh = LocalMesh(shape, "cpu")
    fg, cg = _k2_ghosts(mesh, tiles)
    whole, whole_cnt = rebin_axes_call_plain(slab, geom, EVAC)
    out = []
    for d, t in enumerate(tiles):
        rs, cs, r0, c0 = _cut(arrays[0], shape, d)
        got, cnt = rebin_axes_call_plain(t, geom, EVAC, row0=r0, field_ghosts=fg[d],
                                         col0=c0, col_ghosts=cg[d])
        ext = J.SlabState(*(jnp.asarray(_np_ring(a, shape, d, 2, fill))
                            for a, fill in zip(arrays, SLAB_FILLS)))
        want, _ = J.grid_rebin_axes(ext, jg, EVAC, row0=r0 - 2, col0=c0 - 2)
        for f, g, w, full in zip(SlabState._fields, got, want, whole):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 2:-2, 2:-2],
                                          err_msg=f"{f} tile {d}")
            assert torch.equal(g, full[:, rs, cs]), f"{f} tile {d}"
        assert torch.equal(cnt, whole_cnt[:, rs, cs])
        out.append(got)
    assert _moved(tiles, out) > 0
    assert int(whole_cnt[0].sum()) == 0 and int(whole_cnt[1].sum()) == int(whole_cnt[2].sum())
    if contention:
        assert int(whole_cnt[3].sum()) > 0


def test_axes_rebin_tile_twin_matches_jax_pallas_tile_kernel():
    """K2's twin on tile 3 of a contended 2 x 2 mesh (row and column offsets,
    ghosts west and above, the corner where four tiles meet) against
    rebin_axes_call_pallas(row0, col0, field_ghosts) in interpret mode on the
    JAX route's column-extended arrays (2 real ghost columns in 4-lane
    blocks), ghost lanes sliced off: bitwise, count planes included."""
    shape, d = (2, 2), 3
    geom, slab, arrays, tiles = _edge_tiles(shape, True, seed=8)
    fg, cg = _k2_ghosts(LocalMesh(shape, "cpu"), tiles)
    rs, cs, r0, c0 = _cut(arrays[0], shape, d)
    got, cnt = rebin_axes_call_plain(tiles[d], geom, EVAC, row0=r0, field_ghosts=fg[d],
                                     col0=c0, col_ghosts=cg[d])
    parts = [_np_lane_tile(a, shape, d, 2, fill, 1, 2 if k in (0, 4) else 1)
             for k, (a, fill) in enumerate(zip(arrays, SLAB_FILLS))]
    jstate = J.SlabState(*(jnp.asarray(p[0]) for p in parts))
    jg = _jgeom(geom, cols_pad=cs.stop - cs.start + 2 * LANES)
    want, wcnt = rebin_axes_call_pallas(
        jstate, jg, EVAC, interpret=True, row0=r0, col0=c0 - LANES,
        field_ghosts=[(jnp.asarray(p[1]), jnp.asarray(p[2])) for p in parts])
    inner = (slice(None), slice(None), slice(LANES, -LANES))
    for f, g, w in zip(SlabState._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[inner], err_msg=f)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt)[inner].astype(np.int32))
    assert int(cnt[3].sum()) > 0  # deferred movers on this tile


# --------------------------------------------------------------------- K1
def _step_tiles(shape):
    """GRID_TEST's packed init slab on the tile engine's geometry, live
    particles drifted by up to 0.3 bins (pairs meet inside the cutoff, none
    much closer than half of it: the drift of testing.step_slab), as numpy
    arrays."""
    eng = get_engine("sharded_tile", GRID_TEST, device="cpu", mesh_shape=shape, col_block=8)
    carry = eng.init_carry(init_particles(GRID_TEST, seed=42))
    arrays = [a.copy() for a in tiles_to_numpy(carry.slab, shape)]
    rng = np.random.default_rng(5)
    live = arrays[4] >= 0
    bs = eng.geom.bin_size
    for k in (0, 1):
        arrays[k][live] += rng.uniform(-0.3 * bs, 0.3 * bs, live.sum()).astype(np.float32)
    return eng.geom, arrays


def test_step_tile_twin_matches_single_device_and_jax_tile_kernel():
    """K1's twin with row0, col0, ghost rows and ghost columns on every tile
    of a 2 x 2 mesh: bitwise the single-device twin's bins (the ghosts
    matter: without them the edge bins' forces change); and on tile 3
    against grid_step_pallas(row0, col0, ghosts) in interpret mode on the JAX
    route's column-extended arrays (1 real ghost column in 4-lane blocks,
    row ghosts cut from the column-extended neighbours), ghost lanes sliced
    off: allclose."""
    shape = (2, 2)
    geom, arrays = _step_tiles(shape)
    args = (GRID_TEST.cutoff, GRID_TEST.min_r, GRID_TEST.mass, GRID_TEST.dt, GRID_TEST.size)
    tiles = tiles_from_numpy(*arrays, shape)
    mesh = LocalMesh(shape, "cpu")
    gx, gy = (mesh.tile_halo([t[k] for t in tiles], BIG, 1, 1, 1, 1) for k in (0, 1))
    whole = grid_step_plain(*(torch.from_numpy(a) for a in arrays[:4]), geom, *args)
    crossing = 0
    for d, t in enumerate(tiles):
        rs, cs, r0, c0 = _cut(arrays[0], shape, d)
        (tx, bx, wx, ex), (ty, by, wy, ey) = gx[d], gy[d]
        got = grid_step_plain(*t[:4], geom, *args, row0=r0, ghosts=(tx, ty, bx, by),
                              col0=c0, col_ghosts=(wx, wy, ex, ey))
        for name, g, full in zip(("xl", "yl", "vx", "vy", "speed2"), got, whole):
            want = full[:, rs, cs] if full.dim() == 3 else full[rs, cs]
            assert torch.equal(g, want), f"{name} tile {d} vs the whole slab"
        rows_only = grid_step_plain(*t[:4], geom, *args, row0=r0, ghosts=(tx, ty, bx, by),
                                    col0=c0)
        crossing += int((rows_only[2] != got[2]).sum())
    assert crossing > 0
    d = 3
    rs, cs, r0, c0 = _cut(arrays[0], shape, d)
    (tx, bx, wx, ex), (ty, by, wy, ey) = gx[d], gy[d]
    got = grid_step_plain(*tiles[d][:4], geom, *args, row0=r0, ghosts=(tx, ty, bx, by),
                          col0=c0, col_ghosts=(wx, wy, ex, ey))
    jx = _np_lane_tile(arrays[0], shape, d, 1, BIG, 1, 1)
    jy = _np_lane_tile(arrays[1], shape, d, 1, BIG, 1, 1)
    zpad = np.zeros((geom.capacity, rs.stop - rs.start, LANES), np.float32)
    jv = [np.concatenate([zpad, a[:, rs, cs], zpad], 2) for a in arrays[2:4]]
    want = grid_step_pallas(
        jnp.asarray(jx[0]), jnp.asarray(jy[0]), *(jnp.asarray(v) for v in jv),
        _jgeom(geom, cols_pad=cs.stop - cs.start + 2 * LANES), *args, interpret=True,
        row0=r0, col0=c0 - LANES,
        ghosts=tuple(jnp.asarray(g) for g in (jx[1], jy[1], jx[2], jy[2])))
    for name, g, w in zip(("xl", "yl", "vx", "vy", "speed2"), got, want):
        w = np.asarray(w)
        w = w[..., LANES:-LANES]
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_tile_forms_need_the_ghost_rows():
    """Ghost columns without ghost rows are refused, by both twins."""
    geom, _, _, tiles = _edge_tiles((1, 4), False, seed=1)
    t = tiles[1]
    cap, R = geom.capacity, t.xl.shape[1]
    col = torch.full((cap, R + 2, 1), BIG)
    with pytest.raises(ValueError, match="ghost rows"):
        grid_step_plain(*t[:4], geom, 0.01, 1e-4, 0.01, 5e-4, 1.0, col0=8,
                        col_ghosts=(col, col, col, col))
    with pytest.raises(ValueError, match="ghost rows"):
        rebin_axes_call_plain(t, geom, EVAC, col0=8, col_ghosts=[(col, col)] * 5)


# -------------------------------------------------------------------- mesh
def test_local_mesh_2d_halo_corners_and_split_gather():
    """On a hand-built (1, 6, 9) plane split 2 x 3 (tiles of 3 x 3, each bin
    holding 10 * row + col), tile_halo gives each tile its neighbours' rows
    and the columns of the row-extended blocks beside it: the corner bins
    come from the diagonal tiles, -1 beyond the mesh; split / gather round
    trip; a (P, 1) mesh is today's strips."""
    plane = (10 * torch.arange(6)[:, None] + torch.arange(9)[None, :]).float()[None]
    mesh = LocalMesh((2, 3), "cpu")
    assert mesh.shape == (2, 3) and mesh.size == 6 and mesh.coords(4) == (1, 1)
    tiles = mesh.split(plane)
    assert torch.equal(mesh.gather(tiles), plane)
    assert torch.equal(tiles[4], plane[:, 3:6, 3:6])
    halos = mesh.tile_halo(tiles, -1.0, 1, 2, 1, 2)
    padded = torch.full((1, 9, 12), -1.0)
    padded[:, 1:7, 1:10] = plane
    for d, (top, bot, west, east) in enumerate(halos):
        r, c = mesh.coords(d)
        rows, cols = slice(3 * r + 1, 3 * r + 4), slice(3 * c + 1, 3 * c + 4)
        assert torch.equal(top, padded[:, 3 * r:3 * r + 1, cols]), d
        assert torch.equal(bot, padded[:, 3 * r + 4:3 * r + 6, cols]), d
        ext_rows = slice(3 * r, 3 * r + 6)
        assert torch.equal(west, padded[:, ext_rows, 3 * c:3 * c + 1]), d
        assert torch.equal(east, padded[:, ext_rows, 3 * c + 4:3 * c + 6]), d
        assert torch.equal(torch.cat([top, padded[:, rows, cols], bot], 1),
                           padded[:, ext_rows, cols])
    # the corner: tile 4's west column, row -1, is bin (2, 2) of tile 0
    assert float(halos[4][2][0, 0, 0]) == 22.0
    # ring_extend: a tile and its 1-bin ring are the padded plane's bins
    for d, g in enumerate(mesh.tile_halo(tiles, -1.0, 1, 1, 1, 1)):
        r, c = mesh.coords(d)
        assert torch.equal(ring_extend(tiles[d], g),
                           padded[:, 3 * r:3 * r + 5, 3 * c:3 * c + 5]), d
    strips = LocalMesh(3, "cpu")
    assert strips.shape == (3, 1)
    assert torch.equal(strips.gather(strips.split(plane)), plane)
