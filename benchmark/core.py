"""One run of one cell: set-up, the measured window, the traced extras and
the comparison.

The window is a closed loop of whole simulations. Each starts from the same
seeded state and calls the program's public entry, ``Engine.run(state,
nsteps, savefreq)``, which returns once the device has finished and every
frame is in host memory. The window ends at the first simulation end after
``seconds``. The first simulation of the window saves at the mix's
``check_savefreq`` and is the one compared with the reference once the
window has closed; the others save at ``savefreq``.

On several ranks (``benchmark/ranks.py``) every rank runs every engine call
of the run in the same order: the set-up, each simulation of the window,
the traced extras and the readers' own simulation. The seeded state is made
on every rank and checked equal; a barrier starts the window; a simulation
ends on rank 0's clock once every card is done, and rank 0 decides for all
when the window ends. Failures, set-up seconds and memory peaks are the
max over the ranks; rank 0 compares its gathered outputs and prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import check, spec
from benchmark.initstate import lattice_state
from benchmark.ranks import Ranks
from benchmark.reference import Physics
from benchmark.trace import TraceWindow

__all__ = ["Sim", "Traced", "Run", "run_cell", "card_line"]


@dataclasses.dataclass
class Sim:
    start: float
    end: float
    failed: bool

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Traced:
    """What the traced run measures after the window."""

    sim: Optional[TraceWindow]  # one whole simulation through Engine.run
    steps_device_s: Optional[float]  # steps 1..nsteps, CUDA events
    pack_s: float  # host clock, synchronized, profiler off
    gather_s: float
    unsaved_sim_s: float  # pack + steps + gather, no frames


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    config: dict
    mix: dict
    device_name: str
    setup_s: float
    window_start: float
    sims: List[Sim]
    window_peak_bytes: int  # the fullest card's
    traced: Optional[Traced] = None  # rank 0's
    #: each rank's (busy_s, wall_s) of its traced simulation, None where
    #: its trace holds no device activity
    traced_ranks: Optional[List[Optional[Tuple[float, float]]]] = None

    @property
    def n(self) -> int:
        return self.config["sim"]["num_parts"]

    @property
    def nsteps(self) -> int:
        return self.mix["nsteps"]

    @property
    def saves(self) -> bool:
        return self.mix["savefreq"] > 0

    @property
    def window_s(self) -> float:
        return self.sims[-1].end - self.window_start

    def particle_steps_per_s(self) -> float:
        """n * nsteps * (whole simulations that did not fail) / window."""
        done = sum(not s.failed for s in self.sims)
        return self.n * self.nsteps * done / self.window_s

    def median_sim_s(self) -> float:
        return statistics.median(s.seconds for s in self.sims)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _engine(config: dict, device):
    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine

    return get_engine(config["engine"], SimConfig(**config["sim"]), device=device)


def _failed(engine, result) -> bool:
    """A simulation fails when its monitors report a particle dropped, or a
    bin over capacity, after the engine's own escalations (``Engine.run``
    re-runs with more capacity first)."""
    mon = result.monitors
    return int(mon.migrate_dropped) > 0 or int(mon.max_bin_count) > engine.capacity


def _warning(engine, result):
    """The engine's own check of the run's monitors, as text, or None. Its
    stale-bin slack test flags runs whose fastest particle outran the
    cadence's slack; the comparison judges their outputs."""
    try:
        engine.check(result)
    except RuntimeError as err:
        return str(err)
    return None


def _warm_up(engine, state, mix: dict) -> None:
    """One rebin period through ``Engine.run`` for each frame route the
    window takes (kept on the device, or streamed to host memory), so that
    every kernel, buffer and host allocation the window uses exists."""
    from ppsim_tpu_torch.engines.base import MAX_DEVICE_FRAME_BYTES

    steps = max(1, int(engine.rebin_every))
    for sf in sorted({mix["check_savefreq"], mix["savefreq"]}):
        streams = sf > 0 and engine.frame_sink(mix["nsteps"], sf).streams
        engine.run(state, steps, sf,
                   max_device_frame_bytes=0 if streams else MAX_DEVICE_FRAME_BYTES)


def _profiled(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _traced_extras(engine, state, mix: dict, dev: torch.device) -> Traced:
    from torch.profiler import record_function

    nsteps = mix["nsteps"]
    with _profiled(dev) as prof:
        with record_function("bench.sim"):
            engine.run(state, nsteps, mix["savefreq"])
            _sync(dev)
    sim = TraceWindow.from_events(prof.events(), "bench.sim")
    del prof
    # one unsaved simulation in its parts, profiler off: the pack and the
    # gather on the host clock, the steps also between two CUDA events
    timed = dev.type == "cuda"
    if timed:
        first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _sync(dev)
    t0 = time.perf_counter()
    carry = engine.init_carry(state)
    _sync(dev)
    t1 = time.perf_counter()
    if timed:
        first.record()
    carry, _ = engine.run_steps(carry, nsteps, 0)
    if timed:
        last.record()
    _sync(dev)
    t2 = time.perf_counter()
    engine.final_state(carry)
    _sync(dev)
    t3 = time.perf_counter()
    steps_s = first.elapsed_time(last) / 1000.0 if timed else None
    return Traced(sim, steps_s, t1 - t0, t3 - t2, t3 - t0)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        out = f"nvidia-smi failed: {err}"
    return "card: " + (out or "nvidia-smi printed nothing")


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", root: str = spec.ROOT,
             bench_dir: str = spec.BENCH_DIR, program=None):
    """One run of ``cell_name``. Returns ``(result, check_lines)``:
    ``result`` the dict of the run's last line. ``t_start`` is the process's
    start on ``time.time()``'s clock. ``program``, if given, is called with
    the engine before the window (the fault tests break the timed path
    with it). Under a process group of several ranks every rank calls it
    (``benchmark/ranks.py``), and each returns rank 0's verdict."""
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, cell_name)
    config = spec.load_config(cell["config"], bench_dir)
    mix = spec.load_mix(cell["traffic"], bench_dir)
    phys = Physics.of(config["sim"])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ranks = Ranks(dev)
    from ppsim_tpu_torch.state import ParticleState

    sim = config["sim"]
    pos0, vel0 = lattice_state(sim["num_parts"], sim["ndim"], phys.size, seed, dev)
    ranks.check_same(pos0, vel0)
    state = ParticleState(pos0, vel0)
    engine = _engine(config, dev)
    if program is not None:
        program(engine)
    _warm_up(engine, state, mix)
    _sync(dev)

    # ---- the measured window
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ranks.barrier()
    window_start = time.perf_counter()
    setup_s = time.time() - t_start
    sims: List[Sim] = []
    warnings: List[str] = []
    checked = None
    while True:
        sf = mix["check_savefreq"] if not sims else mix["savefreq"]
        s0 = time.perf_counter()
        result = engine.run(state, mix["nsteps"], sf)
        _sync(dev)
        ranks.all_done()
        s1 = time.perf_counter()
        sims.append(Sim(s0, s1, _failed(engine, result)))
        warning = _warning(engine, result)
        if warning is not None:
            warnings.append(warning)
        if checked is None:
            checked = (result.state, result.frames)
        result = None
        if ranks.agree(s1 - window_start >= seconds):
            break
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if ranks.many:
        for s, failed in zip(sims, ranks.max([s.failed for s in sims])):
            s.failed = bool(failed)
        setup_s, setup_peak, peak = ranks.max([setup_s, setup_peak, peak])
        setup_peak, peak = int(setup_peak), int(peak)
        if not ranks.lead:
            checked = None
    if ranks.lead:
        print("simulations (s): " + " ".join(f"{s.seconds:.4f}" for s in sims),
              file=sys.stderr)
        for text in sorted(set(warnings)):
            print(f"monitors of {warnings.count(text)} simulation(s): {text}",
                  file=sys.stderr)

    run = Run(config, mix, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              setup_s, window_start, sims, peak)
    if trace:
        run.traced = _traced_extras(engine, state, mix, dev)
        sim_t = run.traced.sim
        mine = [-1.0, -1.0] if sim_t is None else [sim_t.busy_s, sim_t.wall_s]
        run.traced_ranks = [(b, w) if w >= 0 else None for b, w in ranks.gather(mine)]
    if dev.type == "cuda" and ranks.lead:
        print(card_line(), file=sys.stderr)

    # ---- the comparison, with the program's state freed and rank 0's inputs
    # in host memory (check.compare moves each to the card as it compares it),
    # so that the reference has the card
    del engine, state
    if ranks.lead:
        final, frames = checked
        inputs = [x.cpu() for x in (pos0, vel0, final.pos, final.vel)]
        del final
    del checked, pos0, vel0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks.barrier()
    numbers = None
    if ranks.lead:
        pos0, vel0, final_pos, final_vel = inputs
        t_check = time.perf_counter()
        numbers = check.compare(phys, pos0, vel0, frames,
                                check.frame_steps(mix["nsteps"], mix["check_savefreq"]),
                                final_pos, final_vel, mix["nsteps"], dev)
        print(f"comparison: {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    numbers = ranks.from_lead(numbers)
    limits = config["limits"]
    failed = sum(s.failed for s in sims)
    correct = check.verdict(numbers, limits) and failed == 0

    metrics: Dict[str, dict] = {}
    # every rank reads (spans.measure's simulation runs on all); rank 0 prints
    with contextlib.nullcontext() if ranks.lead else contextlib.redirect_stderr(io.StringIO()):
        for m in spec.metrics_for(bench, cell_name, trace):
            value = spec.load_reader(m["name"], bench_dir)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": len(sims),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": run.device_name,
            "count": ranks.world,
            "memory_peak_bytes": max(setup_peak, peak),
        },
    }
    out["monitor_warnings"] = len(warnings)
    if trace and run.traced.sim is not None:
        out["device"]["busy_s"] = run.traced.sim.busy_s
        out["device"]["window_s"] = run.traced.sim.wall_s
        out["breakdown"] = {"device_ops": run.traced.sim.device_ops(),
                            "idle_gaps": run.traced.sim.idle_gaps()}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return out, check.check_lines(numbers, limits)
