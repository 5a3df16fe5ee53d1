"""The reader of ``test_lane_use`` on fake runs: K3's distance tests over 32
lanes of each warp pass of the test, from the counters of the spans-on
simulation; nothing for a program without those counters, for a run that
counted no pass (off the card), or for a mix that saves frames."""

import pytest

from benchmark import core, spec
from benchmark.spans import Measured, Reading

H100 = "NVIDIA H100 80GB HBM3"


def _run(savefreq, before, after):
    cfg = {"sim": {"num_parts": 1000, "ndim": 3, "density": 7e-6, "cutoff": 0.01,
                   "force_law": "lj"}}
    run = core.Run(cfg, {"nsteps": 100, "savefreq": savefreq}, H100, 7.5, 10.0,
                   [core.Sim(10.0, 11.0, False)], 1 << 30, None)
    run.spans_measured = Measured(Reading([]), before, after)
    return run


def test_lane_use_of_the_counted_test_passes():
    read = spec.load_reader("test_lane_use")
    before = {"steps_run": 0, "pair_tests": 9000, "test_warp_passes": 400}
    after = {"steps_run": 100, "pair_tests": 9000 + 27200, "test_warp_passes": 400 + 1000}
    assert read(_run(0, before, after)) == pytest.approx(100 * 27200 / (32 * 1000))


@pytest.mark.parametrize("case", ["parent", "no passes", "saved"])
def test_lane_use_reads_nothing_without_test_passes(case):
    read = spec.load_reader("test_lane_use")
    counted = {"steps_run": 100, "pair_tests": 27200, "test_warp_passes": 1000}
    zero = {"steps_run": 0, "pair_tests": 0, "test_warp_passes": 0}
    if case == "parent":
        run = _run(0, {"steps_run": 0, "pair_hits": 0, "coef_warp_passes": 0},
                   {"steps_run": 100, "pair_hits": 1600, "coef_warp_passes": 100})
    elif case == "no passes":
        run = _run(0, zero, dict(counted, test_warp_passes=0))
    else:
        run = _run(10, zero, counted)
    assert read(run) is None
