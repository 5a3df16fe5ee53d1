"""The program's spans and counters (``profiling.span``, ``tracing``,
``Counters``) on the CPU: off by default and absent from a profile; inside
``tracing()`` the run path's spans, nested on one thread; the same outputs
either way; the counters of frames and of a capacity re-run; the CLI's
trace and metrics record; and the busy time of ``ProfileWindow`` as a
union of intervals."""

import collections
import contextlib
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppsim_tpu_torch import profiling
from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.engines import get_engine
from ppsim_tpu_torch.harness import main
from ppsim_tpu_torch.initlib import init_particles

RUNS = {  # engine, config, nsteps, savefreq
    "grid": ("grid", dict(num_parts=200), 20, 10),
    "grid3d": ("grid3d", dict(num_parts=400, ndim=3, density=7e-6), 20, 10),
    "binned": ("binned", dict(num_parts=200), 20, 10),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The engines run many small ops: under the suite's parallel workers,
    torch's intra-op threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine_and_state(case):
    name, cfg, _, _ = RUNS[case]
    cfg = SimConfig(**cfg)
    return get_engine(name, cfg, device="cpu"), init_particles(cfg, seed=3)


def _spans(prof):
    """``[(name, args, parent's name, thread), ...]`` of the host's ppsim.*
    events, parents by containment on their thread (read from the Kineto
    results: ``prof.events()`` takes seconds to build its tree here)."""
    cpu = torch.autograd.DeviceType.CPU
    events = sorted((k.start_ns(), -k.end_ns(), k.name(), k.start_thread_id())
                    for k in prof.profiler.kineto_results.events()
                    if k.device_type() == cpu and k.name().startswith("ppsim."))
    out, stacks = [], collections.defaultdict(list)
    for start, neg_end, label, thread in events:
        stack = stacks[thread]
        while stack and stack[-1][0] < -neg_end:
            stack.pop()
        name, args = profiling.parse_span(label)
        out.append((name, args, stack[-1][1] if stack else None, thread))
        stack.append((-neg_end, name))
    return out


def _run(case, spans_on, profiled=True, **kw):
    eng, state = _engine_and_state(case)
    _, _, nsteps, savefreq = RUNS[case]
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU])) if profiled else None
        if spans_on:
            stack.enter_context(profiling.tracing())
        result = eng.run(state, nsteps, savefreq, **kw)
    return eng, result, _spans(prof) if profiled else None


def test_spans_off_are_one_null_context_and_record_nothing():
    assert profiling.span("ppsim.a") is profiling.span("ppsim.b", {"row": 1})
    with profiling.span("ppsim.a"):
        pass
    _, _, spans = _run("grid", False, max_device_frame_bytes=0)
    assert spans == []


def test_tracing_restores_the_state_before_it():
    with profiling.tracing():
        with profiling.tracing():
            pass
        assert profiling.span("ppsim.a") is not profiling.span("ppsim.a")
    assert profiling.span("ppsim.a") is profiling.span("ppsim.b")


@pytest.mark.parametrize("case", sorted(RUNS))
def test_spans_of_a_streamed_run_nest_on_one_thread(case):
    eng, result, spans = _run(case, True, max_device_frame_bytes=0)
    frames = len(result.frames)
    assert frames == RUNS[case][2] // RUNS[case][3]
    count = collections.Counter(name for name, *_ in spans)
    assert count == {"ppsim.run": 1, "ppsim.pack": 1, "ppsim.steps": 1,
                     "ppsim.gather": 1, "ppsim.result": 1,
                     **{f"ppsim.frame.{k}": frames
                        for k in ("gather", "copy", "land", "wait", "host_copy")}}
    assert len({thread for *_, thread in spans}) == 1
    parents = collections.defaultdict(set)
    for name, _, parent, _ in spans:
        parents[name].add(parent)
    assert parents["ppsim.run"] == {None}
    for name in ("ppsim.pack", "ppsim.steps", "ppsim.gather", "ppsim.result"):
        assert parents[name] == {"ppsim.run"}, name
    assert parents["ppsim.frame.gather"] == parents["ppsim.frame.copy"] == {"ppsim.steps"}
    assert parents["ppsim.frame.land"] <= {"ppsim.frame.copy", "ppsim.steps", "ppsim.result"}
    assert parents["ppsim.frame.wait"] == parents["ppsim.frame.host_copy"] == {"ppsim.frame.land"}
    run_args = next(args for name, args, *_ in spans if name == "ppsim.run")
    assert run_args == {"engine": eng.name, "n": str(eng.config.num_parts),
                        "nsteps": str(RUNS[case][2]),
                        "savefreq": "10", "ordinal": "1", "rerun": "0"}
    rows = [args["row"] for name, args, *_ in spans if name == "ppsim.frame.gather"]
    assert rows == [str(k) for k in range(frames)]


@pytest.mark.parametrize("budget", [0, None])
def test_outputs_are_bitwise_the_same_with_spans_on(budget):
    kw = {} if budget is None else {"max_device_frame_bytes": budget}
    _, off, _ = _run("grid", False, profiled=False, **kw)
    _, on, _ = _run("grid", True, profiled=False, **kw)
    assert torch.equal(off.state.pos, on.state.pos) and torch.equal(off.state.vel, on.state.vel)
    assert np.array_equal(off.frames, on.frames)


def test_counters_of_streamed_and_kept_frames():
    eng, result, _ = _run("grid", False, profiled=False, max_device_frame_bytes=0)
    c = eng.counters
    frames = len(result.frames)
    assert (c.runs, c.reruns, c.steps_run, c.steps_discarded) == (1, 0, 20, 0)
    assert (c.frames_streamed, c.frames_kept) == (frames, 0)
    assert c.frame_bytes_streamed == frames * 200 * 2 * 4
    assert c.frame_wait_s >= 0.0 and c.frame_host_copy_s > 0.0
    eng.run(init_particles(eng.config, seed=3), 20, 10)
    assert (c.runs, c.steps_run, c.frames_streamed, c.frames_kept) == (2, 40, frames, frames)
    record = c.record()
    assert set(record) >= {"reruns", "steps_discarded", "frames_streamed", "frame_wait_s",
                           "frame_host_copy_s", "kernel_builds", "kernel_build_s"}


def test_a_capacity_rerun_is_counted_and_marked():
    """An initial packing over the auto capacity escalates it and re-runs
    the simulation once (grid.py's drop-detected escalation)."""
    eng, state = _engine_and_state("grid")
    eng.geom = dataclasses.replace(eng.geom, capacity=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        eng.run(state, 20, 10)
    c = eng.counters
    assert (c.runs, c.reruns, c.steps_run, c.steps_discarded) == (2, 1, 40, 20)
    runs = [args for name, args, *_ in _spans(prof) if name == "ppsim.run"]
    assert [(a["ordinal"], a["rerun"]) for a in runs] == [("1", "0"), ("2", "1")]


def test_cli_trace_holds_the_spans_and_metrics_the_counters(tmp_path):
    out = tmp_path / "traj.txt"
    metrics = tmp_path / "m.jsonl"
    rc = main(["-n", "200", "-s", "1", "--device", "cpu", "--steps", "8",
               "--savefreq", "4", "-o", str(out), "--trace", str(tmp_path / "tr"),
               "--metrics", str(metrics)])
    assert rc == 0
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {n.split(" ")[0] for n in names if n.startswith("ppsim.")}
    assert found >= {"ppsim.pack", "ppsim.steps", "ppsim.frame.gather", "ppsim.frame.land",
                     "ppsim.gather", "ppsim.result"}
    record = json.loads(metrics.read_text().splitlines()[-1])
    assert record["reruns"] == 0 and record["steps_discarded"] == 0
    assert record["frames_kept"] >= 2 and record["frame_host_copy_s"] >= 0.0
    for key in ("frames_streamed", "frame_wait_s", "kernel_build_s"):
        assert key in record


def test_span_labels_carry_their_arguments():
    label = profiling.span_label("ppsim.run", {"ordinal": 3, "rerun": 1})
    assert label == "ppsim.run ordinal=3 rerun=1"
    assert profiling.parse_span(label) == ("ppsim.run", {"ordinal": "3", "rerun": "1"})
    assert profiling.parse_span("ppsim.steps") == ("ppsim.steps", {})


def test_profile_window_idle_share_takes_the_union_of_streams():
    """A copy stream's overlap with the compute stream counts once."""
    compute, copy = [(0.0, 4.0), (5.0, 6.0)], [(3.0, 5.5), (8.0, 9.0)]
    busy = profiling.union_ms(compute + copy)
    assert busy == pytest.approx(7.0)
    kernel_ms = sum(b - a for a, b in compute + copy)
    w = profiling.ProfileWindow(range(1, 3), 10.0, kernel_ms, [("k", kernel_ms, 4)], busy)
    assert w.idle_share == pytest.approx(0.3)  # 1 - 8.5 / 10 would read 0.15
    assert "7.000 ms busy" in w.table()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = lambda dt, a, b, note=False: SimpleNamespace(  # noqa: E731
        device_type=dt, is_user_annotation=note,
        time_range=SimpleNamespace(start=a * 1e3, end=b * 1e3))
    events = [ev(cuda, a, b) for a, b in compute + copy] + [
        ev(cuda, 0.0, 10.0, note=True), ev(cpu, 0.0, 10.0)]
    assert profiling.union_ms(profiling.device_intervals_ms(events)) == pytest.approx(7.0)


def test_build_counters_start_empty_without_a_card():
    from ppsim_tpu_torch import _build

    if _build._kernels is None:
        assert _build.kernel_builds == 0 and _build.kernel_build_s is None
    path = _build.library_path("x", [], lambda out: ["cc", out])
    assert os.path.basename(path).startswith("libx-")
