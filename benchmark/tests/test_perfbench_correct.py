"""The comparison that decides ``correct``, shown to fail: a tiny run of
the harness on the CPU (the program's plain twins behind the same engine
calls), sound and with the timed path broken underneath, and the control
in a lower precision against the cells' own limits."""

import pytest
import torch

from benchmark import check, core, spec
from benchmark.initstate import lattice_state
from benchmark.reference import Physics
from benchmark.tests import tiny

CELLS = ["tiny2d.short", "tiny2d.short10", "tiny3d.short", "tiny3d.short10"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, program=None, trace=False, seed=2 ** 31 + 11):
    return core.run_cell(cell, seed, 0.0, trace, 0.0, device="cpu", root=tree,
                         bench_dir=tree, program=program)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tree, cell):
    out, lines = _run(tree, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["checks"]) == {"bad_rows", "start_gap", "end_gap", "end_bulk_gap"}
    assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in out["checks"]]
    assert "setup_s" in out["metrics"]
    assert out["device"]["platform"] == "cpu"


def _unchanged(engine):
    engine.move_phase = lambda slab: (slab, torch.zeros(()))


def _half(engine):
    move = engine.move_phase

    def half(slab):
        new, speed = move(slab)
        keep = slab.pid % 2 == 0
        planes = [torch.where(keep, a, b) for a, b in zip(slab[:-1], new[:-1])]
        return type(new)(*planes, new.pid), speed
    engine.move_phase = half


def _altered(engine):
    final = engine.final_state

    def altered(carry):
        st = final(carry)
        pos = st.pos.clone()
        pos[7, 0] += 1e-5
        return type(st)(pos, st.vel)
    engine.final_state = altered


def _altered_frame(engine):
    frame_of = engine.frame_of

    def altered(carry):
        f = frame_of(carry).clone()
        f[3, 1] -= 1e-5
        return f
    engine.frame_of = altered


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half,
          "answer_altered": _altered, "frame_altered": _altered_frame}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny2d.short", "tiny3d.short10"])
def test_broken_timed_path_is_not_correct(tree, cell, fault):
    out, _ = _run(tree, cell, FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,tiny_name", [("hw2_2d_16m", "tiny2d"), ("lj3d_20m", "tiny3d")])
def test_control_fails_the_cells_limits(name, tiny_name):
    """The reference in bfloat16 in the program's place fails the limits of
    the configuration whose physics it has; the program passes them."""
    from benchmark.core import _engine
    from ppsim_tpu_torch.state import ParticleState

    limits = spec.load_config(name)["limits"]
    cfg = dict(tiny.TINY[tiny_name], limits=limits)
    phys = Physics.of(cfg["sim"])
    nsteps, sf = 30, 10
    steps = check.frame_steps(nsteps, sf)
    pos0, vel0 = lattice_state(cfg["sim"]["num_parts"], cfg["sim"]["ndim"], phys.size, 5, "cpu")
    result = _engine(cfg, "cpu").run(ParticleState(pos0, vel0), nsteps, sf)
    sound = check.compare(phys, pos0, vel0, result.frames, steps, result.state.pos,
                          result.state.vel, nsteps, "cpu")
    assert check.verdict(sound, limits), sound
    ctl = check.control(phys, pos0, vel0, steps, result.state.pos, result.state.vel,
                        nsteps, "cpu")
    assert not check.verdict(ctl, limits), ctl
    # at this size the box is small and bfloat16 fine-grained there: the
    # control fails the start and the bulk of the end, if not the widest gap
    assert ctl["start_gap"] > limits["start_gap"] and ctl["end_bulk_gap"] > limits["end_bulk_gap"]
