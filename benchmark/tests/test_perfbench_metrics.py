"""The yardstick's arithmetic on synthetic inputs: busy intervals, the
problem's bytes and flops, the rate over whole simulations, and the
readers' silence where there is nothing to read."""

import math
from types import SimpleNamespace

import pytest

from benchmark import core, roofline, spec
from benchmark.trace import TraceWindow, gaps, union_length


def test_union_of_two_overlapping_streams():
    compute = [(0.0, 4.0), (5.0, 6.0)]
    copy = [(3.0, 5.5), (8.0, 9.0)]
    assert union_length(compute + copy) == pytest.approx(7.0)
    assert sum(b - a for a, b in compute + copy) == pytest.approx(8.5)  # double counts
    assert union_length(compute + copy, 1.0, 8.5) == pytest.approx(5.5)
    assert gaps(compute + copy, -1.0, 10.0) == [(-1.0, 0.0), (6.0, 8.0), (9.0, 10.0)]


def test_trace_window_busy_ops_and_gaps():
    w = TraceWindow(0.0, 10.0,
                    [(0.0, 4.0, "k1"), (3.0, 5.0, "memcpy"), (7.0, 8.0, "k1"), (9.0, 12.0, "k2")],
                    [(0.0, 10.0, "outer"), (5.5, 6.5, "aten::copy_"), (8.1, 8.9, "cudaEventSynchronize")])
    assert w.busy_s == pytest.approx(7.0) and w.wall_s == 10.0
    assert w.device_ops() == [["k1", 5.0], ["memcpy", 2.0], ["k2", 1.0]]
    assert w.idle_gaps() == [["host: aten::copy_ (x1)", 2.0], ["host: cudaEventSynchronize (x1)", 1.0]]


def test_from_events_reads_device_and_host():
    ev = lambda name, kind, a, b: SimpleNamespace(  # noqa: E731
        name=name, device_type=f"DeviceType.{kind}", time_range=SimpleNamespace(start=a, end=b))
    events = [ev("bench.sim", "CPU", 0, 1e6), ev("grid_step", "CUDA", 10, 5e5),
              ev("bench.sim", "CUDA", 0, 1e6), ev("aten::sort", "CPU", 5, 20)]
    w = TraceWindow.from_events(events, "bench.sim")
    assert w.busy_s == pytest.approx(0.49999) and [n for *_, n in w.device] == ["grid_step"]
    assert TraceWindow.from_events(events[:1], "bench.sim") is None


def test_short_names_of_device_operations():
    from benchmark.trace import short_name

    assert short_name("void (anonymous namespace)::grid_tile_kernel<(ppsim::Law)0, true>"
                      "(float const*, float*)") == "grid_tile_kernel<(ppsim::Law)0, true>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"
    assert len(short_name("void f<" + "x" * 300 + ">(int)")) == 120


def test_problem_counts_from_n_and_ndim():
    assert roofline.step_bytes(16_384_000, 2) == 16_384_000 * 32
    assert roofline.step_bytes(20_971_520, 3) == 20_971_520 * 48
    # about 0.6 neighbours a particle in both configurations: 0.31 pairs
    assert roofline.mean_pairs(1000, 2, 0.0005, 0.01) == pytest.approx(1000 * math.pi * 0.1)
    assert roofline.mean_pairs(1000, 3, 7e-6, 0.01) / 1000 == pytest.approx(0.299, abs=1e-3)
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    t, bound = roofline.least_step_s(16_384_000, 2, 0.0005, 0.01, "repulsive", peaks)
    assert bound == "bytes" and t == pytest.approx(16_384_000 * 32 / 3.35e12)
    t3, bound3 = roofline.least_step_s(20_971_520, 3, 7e-6, 0.01, "lj", peaks)
    assert bound3 == "bytes" and t3 == pytest.approx(3.004e-4, rel=1e-3)
    assert roofline.step_flops(1000, 2, 0.0005, 0.01, "repulsive") == pytest.approx(
        1000 * math.pi * 0.1 * 17 + 12000)


def _run(savefreq, sims, traced=None, peak=3 << 30, device="NVIDIA H100 80GB HBM3"):
    cfg = {"sim": {"num_parts": 1000, "ndim": 2, "density": 0.0005, "cutoff": 0.01,
                   "force_law": "repulsive"}}
    return core.Run(cfg, {"nsteps": 100, "savefreq": savefreq}, device, 7.5, 10.0, sims,
                    peak, traced)


def test_rate_over_whole_simulations():
    sims = [core.Sim(10.0, 11.0, False), core.Sim(11.0, 12.5, True), core.Sim(12.5, 14.0, False)]
    run = _run(0, sims)
    assert run.window_s == 4.0
    assert run.particle_steps_per_s() == pytest.approx(1000 * 100 * 2 / 4.0)
    read = lambda name, r=run: spec.load_reader(name)(r)  # noqa: E731
    assert read("particle_steps_per_s") == pytest.approx(50_000.0)
    assert read("saved_particle_steps_per_s") is None
    assert read("peak_device_gib") == 3.0 and read("setup_s") == 7.5
    saved = _run(10, sims)
    assert spec.load_reader("saved_particle_steps_per_s")(saved) == pytest.approx(50_000.0)
    assert spec.load_reader("particle_steps_per_s")(saved) is None


def test_traced_readers():
    sim = TraceWindow(0.0, 2.0, [(0.0, 1.5, "k")], [])
    traced = core.Traced(sim, 0.5, 0.01, 0.02, 1.0)
    run = _run(0, [core.Sim(0.0, 2.0, False)], traced)
    read = lambda name, r=run: spec.load_reader(name)(r)  # noqa: E731
    assert read("device_idle_share.unsaved") == pytest.approx(25.0)
    assert read("device_idle_share.saved") is None
    assert read("pack_gather_ms") == pytest.approx(30.0)
    least = 1000 * 32 / 3.35e12
    assert read("step_roofline_share") == pytest.approx(100 * least / (0.5 / 100))
    saved = _run(10, [core.Sim(0.0, 2.0, False), core.Sim(2.0, 6.0, False)], traced)
    assert spec.load_reader("frame_overhead_share")(saved) == pytest.approx(100 * (1 - 1.0 / 3.0))
    assert spec.load_reader("device_idle_share.saved")(saved) == pytest.approx(25.0)


def test_readers_find_nothing_and_return_nothing():
    bare = _run(0, [core.Sim(0.0, 1.0, False)], None, peak=0, device="cpu")
    for name in ("device_idle_share.unsaved", "device_idle_share.saved", "step_roofline_share",
                 "pack_gather_ms", "frame_overhead_share", "peak_device_gib"):
        assert spec.load_reader(name)(bare) is None, name
    no_trace = core.Traced(None, None, 0.0, 0.0, 1.0)
    untraced = _run(0, [core.Sim(0.0, 1.0, False)], no_trace, device="some other card")
    assert spec.load_reader("step_roofline_share")(untraced) is None
    assert spec.load_reader("device_idle_share.unsaved")(untraced) is None


def test_frame_steps_and_verdict():
    from benchmark import check

    assert check.frame_steps(1000, 990) == [1, 991]
    assert check.frame_steps(1000, 10)[:3] == [1, 11, 21] and len(check.frame_steps(1000, 10)) == 100
    assert check.frame_steps(1000, 0) == []
    limits = {"bad_rows": 0, "start_gap": 1e-4, "end_gap": 1e-3, "end_bulk_gap": 1e-4}
    good = {"bad_rows": 0.0, "start_gap": 1e-5, "end_gap": 1e-4, "end_bulk_gap": 1e-5}
    assert check.verdict(good, limits)
    assert not check.verdict(dict(good, end_gap=float("nan")), limits)
    assert not check.verdict(dict(good, bad_rows=1.0), limits)
    assert not check.verdict({"bad_rows": 0.0, "start_gap": 1e-5}, limits)  # no end compared
    assert not check.verdict(dict(good, end_bulk_gap=2e-4), limits)
