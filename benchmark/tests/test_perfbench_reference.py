"""The plain reference on tiny states, against an all-pairs sum written
here, and its reverse step; its cell list against the dense enumeration
it replaced, kept here as the oracle."""

import itertools
import math
import time

import pytest
import torch

from benchmark import reference
from benchmark.initstate import lattice_state
from benchmark.reference import Physics

SIMS = {
    2: {"num_parts": 256, "ndim": 2, "force_law": "repulsive", "density": 0.0005,
        "mass": 0.01, "cutoff": 0.01, "dt": 0.0005},
    3: {"num_parts": 300, "ndim": 3, "force_law": "lj", "lj_epsilon": 0.0001,
        "lj_sigma": 0.007, "density": 7e-06, "mass": 0.01, "cutoff": 0.01, "dt": 0.0001},
}


def _all_pairs(pos, phys):
    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = x_j - x_i
    r2 = (d * d).sum(-1)
    r2c = r2.clamp(min=phys.min_r ** 2)
    if phys.law == "repulsive":
        coef = (1 - phys.cutoff / r2c.sqrt()) / r2c / phys.mass
    else:
        s6 = (phys.sigma ** 2 / r2c) ** 3
        coef = -24 * phys.epsilon * (2 * s6 * s6 - s6) / r2c / phys.mass
    coef = torch.where((r2 <= phys.cutoff ** 2) & ~torch.eye(len(pos), dtype=bool), coef, 0.0)
    return (coef[..., None] * d).sum(1)


def _crowded(ndim, seed=3):
    """Uniform positions in the box: many pairs within the cutoff, some
    across cell faces and near the walls."""
    phys = Physics.of(SIMS[ndim])
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((SIMS[ndim]["num_parts"], ndim), generator=g, dtype=torch.float64) * phys.size
    return pos, phys


@pytest.mark.parametrize("ndim", [2, 3])
def test_accel_equals_the_all_pairs_sum(ndim):
    pos, phys = _crowded(ndim)
    ref = _all_pairs(pos, phys)
    assert (ref != 0).any(1).sum() > 20  # the test state has pairs in range
    torch.testing.assert_close(reference.accel(pos, phys), ref, rtol=1e-12, atol=1e-9)


def _close_pairs(pos, phys):
    """Ordered pairs closer than the cutoff that the cell list yields."""
    total = 0
    for i, j in reference._pairs(pos, phys):
        d = pos[j] - pos[i]
        total += int(((d * d).sum(1) <= phys.cutoff ** 2).sum())
    return total


@pytest.mark.parametrize("ndim", [2, 3])
def test_cell_list_yields_every_close_pair_once(ndim):
    pos, phys = _crowded(ndim)
    d = pos[None] - pos[:, None]
    r2 = (d * d).sum(-1)
    assert _close_pairs(pos, phys) == int((r2 <= phys.cutoff ** 2).sum()) - len(pos)


@pytest.mark.parametrize("ndim", [2, 3])
def test_reverse_step_undoes_forward_step(ndim):
    phys = Physics.of(SIMS[ndim])
    pos, _ = lattice_state(SIMS[ndim]["num_parts"], ndim, phys.size, 4, "cpu")
    # a lattice squeezed to 0.4 of its spacing: every particle has
    # neighbours within the cutoff, none much closer than sigma
    pos = pos.to(torch.float64) * 0.4
    g = torch.Generator().manual_seed(9)
    vel = torch.rand(pos.shape, generator=g, dtype=torch.float64) * 2 - 1
    # walls: four particles cross one in the first step
    vel[:4, 0] = -vel[:4, 0].abs()
    pos[:4, 0] = 0.3 * vel[:4, 0].abs() * phys.dt
    p, v = pos, vel
    for _ in range(5):
        p, v = reference.forward_step(p, v, phys)
    assert ((p >= 0) & (p <= phys.size)).all()
    for _ in range(5):
        p, v = reference.reverse_step(p, v, phys)
    torch.testing.assert_close(p, pos, rtol=0, atol=1e-11)
    torch.testing.assert_close(v, vel, rtol=0, atol=1e-8)


def test_physics_of_a_config():
    phys = Physics.of(dict(SIMS[2], num_parts=16_384_000))
    assert phys.size == math.sqrt(0.0005 * 16_384_000) and phys.min_r == 0.0001
    assert Physics.of(SIMS[3]).size == pytest.approx((7e-06 * 300) ** (1 / 3))


@pytest.mark.parametrize("ndim", [2, 3])
def test_lattice_state_is_seeded_and_on_the_lattice(ndim):
    phys = Physics.of(SIMS[ndim])
    n = SIMS[ndim]["num_parts"]
    pos, vel = lattice_state(n, ndim, phys.size, 2 ** 31 + 7, "cpu")
    again = lattice_state(n, ndim, phys.size, 2 ** 31 + 7, "cpu")
    other = lattice_state(n, ndim, phys.size, 2 ** 31 + 8, "cpu")
    assert pos.dtype == vel.dtype == torch.float32 and pos.shape == (n, ndim)
    assert torch.equal(pos, again[0]) and torch.equal(vel, again[1])
    assert not torch.equal(pos, other[0])
    assert ((vel >= -1) & (vel < 1)).all()
    assert ((pos > 0) & (pos < phys.size)).all()
    # every lattice point once: the sorted positions do not depend on the seed
    key = lambda p: sorted(map(tuple, p.tolist()))  # noqa: E731
    assert key(pos) == key(other[0])


def test_pairs_in_small_batches_give_the_same_forces(monkeypatch):
    pos, phys = _crowded(2)
    whole = reference.accel(pos, phys)
    monkeypatch.setattr(reference, "MAX_PAIRS", 7)
    torch.testing.assert_close(reference.accel(pos, phys), whole, rtol=1e-12, atol=1e-9)
    # a lower precision piles particles onto one point: still every pair
    heap = torch.full((50, 2), 0.25, dtype=torch.float64)
    assert _close_pairs(heap, phys) == 50 * 49


def _dense_pairs(pos, phys):
    """The cell list as it was: dense tables of a count and a start for
    every cell of the box, occupied or not."""
    n, ndim = pos.shape
    dev = pos.device
    nc = max(1, int(math.floor(phys.size / phys.cutoff)))
    side = phys.size / nc
    cell = torch.clamp(torch.floor(pos.to(torch.float64) / side).long(), 0, nc - 1)
    stride = torch.tensor([nc ** k for k in range(ndim)], device=dev)
    flat = (cell * stride).sum(1)
    order = torch.argsort(flat)
    counts = torch.bincount(flat, minlength=nc ** ndim)
    starts = torch.cumsum(counts, 0) - counts
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        nb = cell + torch.tensor(off, device=dev)
        inside = ((nb >= 0) & (nb < nc)).all(1)
        nflat = torch.where(inside, (nb.clamp(0, nc - 1) * stride).sum(1), 0)
        cnt = torch.where(inside, counts[nflat], 0)
        ends = torch.cumsum(cnt, 0)
        lo = 0
        while lo < n:
            base = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(ends, base + reference.MAX_PAIRS,
                                                    right=True)))
            c = cnt[lo:hi]
            size = int(ends[hi - 1]) - base
            if size:
                i = torch.repeat_interleave(torch.arange(lo, hi, device=dev), c,
                                            output_size=size)
                k = torch.arange(size, device=dev) - (torch.cumsum(c, 0) - c)[i - lo]
                j = order[starts[nflat[i]] + k]
                keep = j != i
                yield i[keep], j[keep]
            lo = hi


def _dense_accel(pos, phys):
    acc = torch.zeros_like(pos)
    for i, j in _dense_pairs(pos, phys):
        d = pos[j] - pos[i]
        coef = reference._coef((d * d).sum(1), phys)
        acc.index_add_(0, i, coef[:, None] * d)
    return acc


def _states(ndim):
    """Uniform, the seeded lattice squeezed so that neighbours are in range,
    a lower precision's heap on one point, and rows on the box's faces and
    corners (the cells at the edge of each axis)."""
    pos, phys = _crowded(ndim)
    lattice, _ = lattice_state(SIMS[ndim]["num_parts"], ndim, phys.size, 6, "cpu")
    heap = torch.full((50, ndim), 0.25, dtype=torch.float64)
    g = torch.Generator().manual_seed(4)
    edge = torch.rand((200, ndim), generator=g, dtype=torch.float64) * phys.size
    edge[::2, 0] = 0.0
    edge[1::3, -1] = phys.size
    return phys, {"uniform": pos, "lattice": lattice.to(torch.float64) * 0.4,
                  "lattice32": lattice, "heap": heap, "edge": edge}


@pytest.mark.parametrize("max_pairs", [7, reference.MAX_PAIRS])
@pytest.mark.parametrize("ndim", [2, 3])
def test_pairs_are_the_dense_enumeration_in_its_order(monkeypatch, ndim, max_pairs):
    monkeypatch.setattr(reference, "MAX_PAIRS", max_pairs)
    phys, states = _states(ndim)
    for name, pos in states.items():
        got = list(reference._pairs(pos, phys))
        want = list(_dense_pairs(pos, phys))
        assert len(got) == len(want), name
        for (i, j), (oi, oj) in zip(got, want):
            assert torch.equal(i, oi) and torch.equal(j, oj), name
        assert torch.equal(reference.accel(pos, phys), _dense_accel(pos, phys)), name


@pytest.mark.parametrize("ndim", [2, 3])
def test_steps_are_bitwise_the_out_of_place_steps(ndim):
    """The in-place fold and steps against the out-of-place forms they
    replaced, in float64 and in the control's bfloat16, walls crossed."""
    def fold(x, v, size):
        m = torch.remainder(x, 2.0 * size)
        return size - torch.abs(m - size), torch.where(m > size, -v, v)

    phys = Physics.of(SIMS[ndim])
    pos, _ = _crowded(ndim)
    g = torch.Generator().manual_seed(8)
    vel = (torch.rand(pos.shape, generator=g, dtype=torch.float64) * 2 - 1) * 40
    for dtype in (torch.float64, torch.bfloat16):
        p, v = pos.to(dtype), vel.to(dtype)
        p0, v0 = p.clone(), v.clone()
        vf = v + reference.accel(p, phys) * phys.dt
        want = fold(p + vf * phys.dt, vf, phys.size)
        got = reference.forward_step(p, v, phys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        pr, vr = fold(p - v * phys.dt, v, phys.size)
        want = (pr, vr - reference.accel(pr, phys) * phys.dt)
        got = reference.reverse_step(p, v, phys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(p, p0) and torch.equal(v, v0)  # the inputs are left as they were
        assert (fold(p + vf * phys.dt, vf, phys.size)[1] != vf).any()  # walls crossed


def test_box_of_a_trillion_cells():
    """Size 10, cutoff 0.001: 10^12 cells, where a dense table of them cannot
    be allocated. 500 pairs a little apart, some across a cell face. Timed
    on one torch thread, so that test workers sharing the host's cores do
    not slow it."""
    phys = Physics(ndim=3, size=10.0, cutoff=0.001, min_r=1e-5, mass=0.01, dt=1e-4,
                   law="lj", epsilon=1e-4, sigma=7e-4)
    g = torch.Generator().manual_seed(12)
    centre = torch.rand((500, 3), generator=g, dtype=torch.float64) * 9.99
    pos = torch.cat([centre, centre + (torch.rand((500, 3), generator=g,
                                                  dtype=torch.float64) - 0.5) * 1.2e-3])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        acc = reference.accel(pos, phys)
        assert time.perf_counter() - t0 < 1.0
    finally:
        torch.set_num_threads(threads)
    ref = _all_pairs(pos, phys)
    assert (ref != 0).any(1).sum() > 100
    torch.testing.assert_close(acc, ref, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_pairs_on_the_card_are_the_dense_enumeration(cuda_card, ndim):
    """The card's sort, unique and binary search give the same pairs in the
    same order (its accelerations differ by the order of index_add_'s
    atomic sums only)."""
    n = 200_000
    phys = Physics.of(dict(SIMS[ndim], num_parts=n))
    g = torch.Generator(device=cuda_card).manual_seed(10)
    pos = torch.rand((n, ndim), generator=g, device=cuda_card, dtype=torch.float64) * phys.size
    got, want = list(reference._pairs(pos, phys)), list(_dense_pairs(pos, phys))
    assert len(got) == len(want)
    for (i, j), (oi, oj) in zip(got, want):
        assert torch.equal(i, oi) and torch.equal(j, oj)
    torch.testing.assert_close(reference.accel(pos, phys), _dense_accel(pos, phys),
                               rtol=1e-12, atol=1e-9)
