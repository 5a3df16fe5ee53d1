"""The program's spans as the benchmark reads them: nesting, attribution of
device work by correlation id, self time and idle time under a span on
synthetic events; each reader of a span or counter on a fake run; and a
tiny traced run on the CPU."""

import time

import pytest

from benchmark import core, spans, spec
from benchmark.spans import Ev, Measured, Reading
from benchmark.tests import tiny

H100 = "NVIDIA H100 80GB HBM3"
NEW = ("pack_gather_device_ms", "step_span_roofline_share", "wasted_step_share.unsaved",
       "wasted_step_share.saved", "frame_gather_device_ms", "frame_wait_ms",
       "frame_host_copy_ms", "land_idle_share", "kernel_build_s")


def _events():
    """One saved simulation on one host thread: spans, launch calls (corr
    1-7) and device work on streams 7 (compute) and 9 (copies)."""
    span = lambda label, a, b: Ev(label, "span", a, b, 1)  # noqa: E731
    return [
        span("ppsim.run ordinal=1 rerun=0", 0, 100), span("ppsim.pack", 1, 5),
        span("ppsim.steps", 6, 80), span("ppsim.frame.gather row=0", 10, 12),
        span("ppsim.frame.copy row=0", 12, 13), span("ppsim.frame.land row=0", 14, 30),
        span("ppsim.frame.wait", 14, 25), span("ppsim.frame.host_copy", 25, 30),
        span("ppsim.gather", 81, 90), span("ppsim.result", 91, 99),
        Ev("cudaLaunchKernel", "launch", 2, 2.1, 1, 1),
        Ev("cudaLaunchKernel", "launch", 7, 7.1, 1, 2),
        Ev("cudaLaunchKernel", "launch", 11, 11.1, 1, 3),
        Ev("cudaMemcpyAsync", "launch", 12.5, 12.6, 1, 4),
        Ev("cudaLaunchKernel", "launch", 82, 82.1, 1, 5),
        Ev("cudaLaunchKernel", "launch", 150, 150.1, 1, 6),
        Ev("cudaLaunchKernel", "launch", 39, 39.1, 1, 7),
        Ev("k_pack", "device", 2, 4, 7, 1), Ev("k_step", "device", 7, 20, 7, 2),
        Ev("index_put", "device", 20, 22, 7, 3),
        Ev("Memcpy DtoH (Device -> Pinned)", "device", 21, 26, 9, 4),
        Ev("k_gather", "device", 83, 85, 7, 5), Ev("k_late", "device", 150, 151, 7, 6),
        Ev("k_late_step", "device", 40, 45, 7, 7),
        Ev("k_unlinked", "device", 46, 47, 7, 77),  # no launch call has its id
    ]


def test_spans_nest_by_containment_and_keep_their_arguments():
    r = Reading(_events())
    by = {s.name: s for s in r.spans}
    assert by["ppsim.run"].args == {"ordinal": "1", "rerun": "0"} and by["ppsim.run"].parent is None
    assert by["ppsim.frame.host_copy"].chain == (
        "ppsim.frame.host_copy", "ppsim.frame.land", "ppsim.steps", "ppsim.run")
    assert by["ppsim.frame.gather"].args == {"row": "0"}
    assert by["ppsim.result"].parent is by["ppsim.run"]
    assert r.innermost(26).name == "ppsim.frame.host_copy"
    assert r.innermost(50).name == "ppsim.steps" and r.innermost(200) is None
    assert r.count("ppsim.frame.land") == 1 and r.host_s("ppsim.frame.wait") == 11


def test_device_work_goes_to_the_span_around_its_launch():
    r = Reading(_events())
    # k_late was launched outside every span; k_unlinked has no launch call
    assert [d[2] for d in r.device if not d[3]] == ["k_late", "k_unlinked"]
    assert r.device_s("ppsim.pack") == 2
    assert r.device_s("ppsim.frame.gather") == 2 and r.device_s("ppsim.frame.copy") == 5
    # self time: k_step and k_late_step; with its children the copy overlaps once
    assert r.device_s("ppsim.steps", self_only=True) == 18
    assert r.device_s("ppsim.steps") == pytest.approx(19 + 5)
    assert r.device_s("ppsim.run") == pytest.approx(2 + 19 + 5 + 2)
    assert r.busy_s == pytest.approx(2 + 19 + 5 + 2 + 1 + 1)
    assert r.attributed_s == pytest.approx(28)


def test_idle_time_under_a_span():
    r = Reading(_events())
    # inside ppsim.run [0, 100] the device idles over
    # [0,2] [4,7] [26,40] [45,46] [47,83] [85,100]
    assert sum(b - a for a, b in r.idle_gaps()) == pytest.approx(2 + 3 + 14 + 1 + 36 + 15)
    assert r.idle_under("ppsim.frame.land") == pytest.approx(4)  # [26, 30]
    assert r.idle_under("ppsim.frame.wait") == 0
    # each gap goes to the innermost span over its middle
    table = {label: (s, n) for label, s, n in r.idle_table()}
    assert table == {"ppsim.steps": (pytest.approx(14 + 1 + 36), 3), "ppsim.result": (15, 1),
                     "ppsim.run": (3, 1), "ppsim.pack": (2, 1)}
    assert spans.intersection_length([(0, 2), (1, 5)], [(4, 10), (3, 3.5)]) == pytest.approx(1.5)


def _run(savefreq, measured, traced=None, device=H100):
    cfg = {"sim": {"num_parts": 1000, "ndim": 2, "density": 0.0005, "cutoff": 0.01,
                   "force_law": "repulsive"}}
    run = core.Run(cfg, {"nsteps": 100, "savefreq": savefreq}, device, 7.5, 10.0,
                   [core.Sim(10.0, 11.0, False)], 1 << 30, traced)
    run.spans_measured = measured
    return run


def _measured(discarded=0):
    before = {"steps_run": 0, "steps_discarded": 0}
    return Measured(Reading(_events()), before,
                    {"steps_run": 100 + discarded, "steps_discarded": discarded})


def test_readers_of_a_saved_run():
    run = _run(10, _measured())
    read = lambda name: spec.load_reader(name)(run)  # noqa: E731
    assert read("frame_gather_device_ms") == pytest.approx(2000.0)
    assert read("frame_wait_ms") == pytest.approx(11000.0)
    assert read("frame_host_copy_ms") == pytest.approx(5000.0)
    assert read("land_idle_share") == pytest.approx(100 * 4 / 100)
    assert read("wasted_step_share.saved") == 0.0
    assert read("wasted_step_share.unsaved") is None
    escalated = _run(10, _measured(discarded=100))
    assert spec.load_reader("wasted_step_share.saved")(escalated) == pytest.approx(50.0)


def test_readers_of_an_unsaved_run(capsys):
    least = 1000 * 32 / 3.35e12
    traced = core.Traced(None, 18 * 1.02, 0.0, 0.0, 1.0)
    run = _run(0, _measured(), traced)
    read = lambda name: spec.load_reader(name)(run)  # noqa: E731
    assert read("pack_gather_device_ms") == pytest.approx(1000.0 * (2 + 2))
    assert read("step_span_roofline_share") == pytest.approx(100 * least / (18 / 100))
    assert "2.000% apart (within 3: yes)" in capsys.readouterr().err
    assert read("wasted_step_share.unsaved") == 0.0
    assert spec.load_reader("step_span_roofline_share")(_run(0, _measured(), device="cpu")) is None


def test_readers_of_a_program_without_spans_read_nothing(monkeypatch):
    from ppsim_tpu_torch import profiling

    monkeypatch.delattr(profiling, "tracing")
    assert spans.measure(core.Run({}, {}, "cpu", 0.0, 0.0, [], 0)) is None
    for savefreq in (0, 10):
        bare = _run(savefreq, None)
        for name in NEW[:-1]:
            assert spec.load_reader(name)(bare) is None, name
    no_device = Measured(Reading([e for e in _events() if e.kind == "span"]),
                         {"steps_run": 0}, {"steps_run": 100})
    for name in ("pack_gather_device_ms", "frame_gather_device_ms", "land_idle_share"):
        assert spec.load_reader(name)(_run(10, no_device, device="cpu")) is None, name
    assert spec.load_reader("frame_wait_ms")(_run(10, no_device, device="cpu")) == 11000.0


def test_seed_of_the_command_line():
    assert spans._seed(["run.py", "--workload", "x", "--seed", "2147483911"]) == 2147483911
    assert spans._seed(["pytest", "-q"]) == 0


@pytest.mark.parametrize("cell", ["tiny2d.short10", "tiny2d.short"])
def test_tiny_traced_run_reads_the_new_metrics(tmp_path, monkeypatch, cell):
    """On the CPU the readers of counters and host spans read; those of
    device time read nothing; the earlier readers read the run as before."""
    tree = tiny.make_tree(tmp_path)
    seen = []
    load = spec.load_reader

    def recording(name, bench_dir=spec.BENCH_DIR):
        reader = load(name, bench_dir)

        def read(run):
            seen.append(run)
            return reader(run)
        return read

    monkeypatch.setattr(spec, "load_reader", recording)
    out, _ = core.run_cell(cell, 2 ** 31 + 17, 0.0, True, time.time(), device="cpu",
                           root=tree, bench_dir=tree)
    got = out["metrics"]
    if cell.endswith("short10"):
        assert {"wasted_step_share.saved", "frame_wait_ms", "frame_host_copy_ms"} <= set(got)
        assert got["frame_host_copy_ms"]["value"] > 0
    else:
        assert got["wasted_step_share.unsaved"]["value"] == 0.0
    assert not set(got) & {"pack_gather_device_ms", "step_span_roofline_share",
                           "frame_gather_device_ms", "land_idle_share", "kernel_build_s"}
    run = seen[-1]
    assert run.spans_measured.steps == 30
    for name, m in got.items():
        if name not in NEW:
            assert load(name, tree)(run) == m["value"], name
