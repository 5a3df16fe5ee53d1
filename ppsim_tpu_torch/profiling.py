"""Where the device time goes: per-phase timing and profiler windows (port
of :mod:`ppsim_tpu.profiling`).

- :func:`phase_times` — phase costs of an engine by *variant subtraction*:
  time the step loop with a phase disabled and diff the marginal step time
  (the reference's vecmp.cpp t1..t4 phase table,
  part1/vecmp.cpp:25-32,178-183); slab engines split force+move / rebin,
  particle-list engines force / move. :func:`timeit_steps` gives the marginal
  seconds per step, fenced by ``torch.cuda.synchronize()``.
- :func:`profile_steps` runs ``nsteps`` global steps of an engine from a
  carry under ``torch.profiler`` (CPU and CUDA activities) and returns the
  device time of every kernel by name, the window's wall time (host clock
  around work that ends in ``torch.cuda.synchronize()``) and the device idle
  share, ``1 - busy time / wall time``, busy the union of the device's
  activity intervals. It needs a CUDA device: a window on the CPU measures
  nothing of the card.
- :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (the CLI's ``--trace``), with the program's spans turned on.
- :func:`span` — the program's own spans (``ppsim.run``, ``ppsim.pack``,
  ``ppsim.steps``, ``ppsim.frame.*``, ``ppsim.gather``, ``ppsim.result``,
  ``ppsim.build``): off by default, where a span is one shared null
  context; inside :func:`tracing` each is a ``record_function``, which the
  profiler records on the clock of the CUDA activities, so a span and the
  kernels it launched share one timeline. Spans nest on their thread.
- :class:`Counters` — what an engine did, in plain numbers, always on and
  updated once a run or a frame (``Engine.counters``); with the kernel
  library's build (``_build.kernel_builds``, ``kernel_build_s``) in
  :meth:`Counters.record`. Inside :func:`tracing` the engines that run
  K3 count pairs in range and its coefficient passes on the device, folded
  in once a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["ProfileWindow", "profile_steps", "phase_times", "timeit_steps", "trace",
           "span", "tracing", "spans_on", "span_label", "parse_span", "Counters",
           "union_ms", "device_intervals_ms"]

#: Whether :func:`span` records; only :func:`tracing` sets it.
_spans_on = False
_OFF = contextlib.nullcontext()


def span_label(name: str, args: Optional[dict] = None) -> str:
    """The name a span is recorded under: ``name``, then ``key=value`` for
    each of ``args`` after a space. The profiler keeps no argument string
    of a ``record_function`` in its events or its Chrome trace, so a span's
    arguments travel in its name (:func:`parse_span` splits them off)."""
    if not args:
        return name
    return name + " " + " ".join(f"{k}={v}" for k, v in args.items())


def parse_span(label: str) -> Tuple[str, Dict[str, str]]:
    """``(name, args)`` of a label written by :func:`span_label`."""
    name, _, rest = label.partition(" ")
    return name, dict(kv.split("=", 1) for kv in rest.split())


def span(name: str, args: Optional[dict] = None):
    """A context manager over one piece of the program's work. Off (the
    default) it is one shared ``contextlib.nullcontext()``: no clock read,
    no record. Inside :func:`tracing` it is
    ``torch.profiler.record_function`` under :func:`span_label`, which
    costs ~12 us even with no profiler running."""
    if not _spans_on:
        return _OFF
    return torch.profiler.record_function(span_label(name, args))


def spans_on() -> bool:
    """Whether :func:`span` records (inside :func:`tracing`); the engines
    that run K3 count its pairs only then."""
    return _spans_on


@contextlib.contextmanager
def tracing():
    """Spans on for the block, then as they were. Nothing else turns them
    on: a ``torch.profiler`` window opened elsewhere records none."""
    global _spans_on
    before, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = before


@dataclasses.dataclass
class Counters:
    """What one engine did over its life. Updated once a run, a re-run or a
    frame, never a step; the host seconds are ``time.perf_counter()``
    differences."""

    runs: int = 0  # calls of the base Engine.run
    reruns: int = 0  # simulations re-run after a capacity escalation
    steps_run: int = 0  # steps of Engine.run_steps, re-runs included
    steps_discarded: int = 0  # steps of runs that were then re-run
    frames_kept: int = 0  # frames kept on the device until the run's end
    frames_streamed: int = 0  # frames streamed to host memory as taken
    frame_bytes_streamed: int = 0
    frame_wait_s: float = 0.0  # host blocked on a frame's copy event
    frame_host_copy_s: float = 0.0  # host copying frames into the host array
    # The 3D step's pairs inside the cutoff (self pairs included) and, on
    # the card, K3's warp passes of the pair coefficient, its distance tests
    # and its warp passes of the test, counted by K3 or its twin (cuda3d,
    # sharded_grid3d) in steps run inside tracing(): totals of the engine's
    # device-side counters, read once a run.
    pair_hits: int = 0
    coef_warp_passes: int = 0
    pair_tests: int = 0
    test_warp_passes: int = 0

    def note_rerun(self, steps_before: int) -> None:
        """A re-run follows: the steps run since ``steps_before`` (a value
        of ``steps_run``) were discarded."""
        self.reruns += 1
        self.steps_discarded += self.steps_run - steps_before

    def record(self) -> dict:
        """The counters as a dict, with the process's kernel library build:
        ``kernel_builds`` (compiles; 0 for a cached library) and
        ``kernel_build_s`` (seconds of its first load; None before it)."""
        from ppsim_tpu_torch import _build

        return dict(dataclasses.asdict(self), kernel_builds=_build.kernel_builds,
                    kernel_build_s=_build.kernel_build_s)


def union_ms(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: two streams'
    overlap counts once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit_steps(step_fn, carry, steps_a: int = 10, steps_b: int = 60,
                 reps: int = 3, device="cuda") -> float:
    """Marginal seconds per step of ``step_fn(carry, i)`` (global steps ``i
    = 1, 2, ...``) on ``device``: the best of ``reps`` runs of each of two
    lengths, differenced, so per-run set-up cancels. Each run starts from
    ``carry`` after one untimed run of each length."""
    def run(n: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        c = carry
        for i in range(1, n + 1):
            c = step_fn(c, i)
        _sync(device)
        return time.perf_counter() - t0

    run(steps_a)
    run(steps_b)
    best_a = min(run(steps_a) for _ in range(reps))
    best_b = min(run(steps_b) for _ in range(reps))
    return max(best_b - best_a, 0.0) / (steps_b - steps_a)


def phase_times(engine, state, steps: int = 50) -> Dict[str, float]:
    """Per-phase seconds/step of a slab-family engine (2D or 3D):
    ``{"step", "force+move", "rebin", "overhead"}``. Each phase cost is the
    marginal slowdown against a variant with that phase disabled:
    ``move_phase`` (the fused force + move) or ``rebin_of``, patched on the
    instance for the variant's runs, or, for the sharded engine, skipped by
    its ``_phase_disable`` flag (the JAX package's sharded seam). A
    particle-list engine goes to :func:`_particle_phase_times`; an engine
    with neither seam raises TypeError."""
    from ppsim_tpu_torch.engines.grid import GridEngine
    from ppsim_tpu_torch.ops.grid_ops import RebinMonitors

    if not isinstance(engine, GridEngine):
        return _particle_phase_times(engine, state, steps)
    dev = engine.device
    carry = engine.init_carry(state.to(dev))

    def timed() -> float:
        return timeit_steps(engine.step, carry, 10, 10 + steps, device=dev)

    def timed_without(name: str, stub, phase: str) -> float:
        if hasattr(engine, "_phase_disable"):  # the sharded seam
            engine._phase_disable = phase
            try:
                return timed()
            finally:
                engine._phase_disable = None
        own = vars(engine).get(name)
        setattr(engine, name, stub)
        try:
            return timed()
        finally:
            if own is None:
                delattr(engine, name)
            else:
                setattr(engine, name, own)

    t_full = timed()
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    t_nomove = timed_without("move_phase", lambda slab: (slab, zf), "move")
    t_norebin = timed_without("rebin_of",
                              lambda slab: (slab, RebinMonitors(zi, zi, zi)), "rebin")
    force_move = max(t_full - t_nomove, 0.0)
    rebin = max(t_full - t_norebin, 0.0)
    return {
        "step": t_full,
        "force+move": force_move,
        "rebin": rebin,
        "overhead": max(t_full - force_move - rebin, 0.0),
    }


def _particle_phase_times(engine, state, steps: int = 50) -> Dict[str, float]:
    """Per-phase seconds/step of a particle-list engine (``oracle``,
    ``binned``, ``binned3d``, ``sharded``): ``{"step", "force", "move",
    "other"}``, through its ``_phase_disable`` seam. These engines rebuild
    their bins inside every step (the vecmp strategy,
    part1/vecmp.cpp:88-123), so the sort and grid build land in "other"
    with the loop's overhead. The "force" variant zeroes the accelerations
    but still integrates, so the integrator's cost cancels; "force+move"
    also skips the integrator. The seam is restored to None afterwards."""
    if not hasattr(engine, "_phase_disable"):
        raise TypeError(f"engine {engine.name!r} has no phase seam: phase_times "
                        "needs a slab-family engine or a particle-list engine "
                        "with the _phase_disable flag")
    dev = engine.device
    carry = engine.init_carry(state.to(dev))

    def timed(phase=None) -> float:
        engine._phase_disable = phase
        try:
            return timeit_steps(engine.step, carry, 10, 10 + steps, device=dev)
        finally:
            engine._phase_disable = None

    t_full = timed()
    t_noforce = timed("force")
    t_neither = timed("force+move")
    force = max(t_full - t_noforce, 0.0)
    move = max(t_noforce - t_neither, 0.0)
    return {
        "step": t_full,
        "force": force,
        "move": move,
        "other": max(t_full - force - move, 0.0),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a GPU
    is present), with the program's spans on (:func:`tracing`), written to
    ``log_dir/trace.json`` as a Chrome trace (open it in chrome://tracing
    or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing():
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ProfileWindow(NamedTuple):
    steps: range  # the global steps profiled
    wall_ms: float
    kernel_ms: float  # summed device time of all kernels
    kernels: list  # [(name, device ms, calls), ...], largest first
    busy_ms: float  # the union of the device's activity intervals

    @property
    def idle_share(self) -> float:
        """``1 - busy / wall``; busy is a union, so a copy stream's overlap
        with the compute stream counts once."""
        return 1.0 - self.busy_ms / self.wall_ms

    def table(self, top: int = 8) -> str:
        lines = [f"{'kernel':60s} {'device ms':>11s} {'share':>7s} {'calls':>6s}"]
        for name, ms, calls in self.kernels[:top]:
            lines.append(f"{name[:60]:60s} {ms:11.3f} "
                         f"{100 * ms / self.kernel_ms:6.2f}% {calls:6d}")
        lines.append(f"window {self.wall_ms:.3f} ms wall, {self.kernel_ms:.3f} "
                     f"ms kernels, {self.busy_ms:.3f} ms busy, device idle share "
                     f"{self.idle_share:.4f}")
        return "\n".join(lines)


def device_intervals_ms(events) -> list:
    """``[(start, end), ...]`` in ms of the device activities among
    ``profile.events()``: kernels, copies and memsets, not the ranges the
    profiler draws for user annotations on the device's timeline."""
    out = []
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            out.append((e.time_range.start / 1e3, e.time_range.end / 1e3))
    return out


def profile_steps(engine, carry, first_step: int, nsteps: int):
    """Profile global steps ``first_step .. first_step + nsteps - 1`` of
    ``engine`` from ``carry``; returns ``(carry, ProfileWindow)``."""
    from torch.profiler import ProfilerActivity, profile

    if engine.device.type != "cuda":
        raise RuntimeError("profile_steps measures a CUDA device; the engine "
                           f"runs on {engine.device}")
    steps = range(first_step, first_step + nsteps)
    torch.cuda.synchronize(engine.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in steps:
            carry = engine.step(carry, i)
        torch.cuda.synchronize(engine.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    kernel_ms = sum(r[1] for r in rows)
    if kernel_ms <= 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = union_ms(device_intervals_ms(prof.events()))
    return carry, ProfileWindow(steps, wall_ms, kernel_ms, rows, busy_ms)
