"""The plain reference on tiny states, against an all-pairs sum written
here, and its reverse step."""

import math

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
