"""Where the device time goes: per-phase timing and profiler windows (port
of :mod:`ppsim_tpu.profiling`).

- :func:`phase_times` — phase costs of a slab-family engine by *variant
  subtraction*: time the step loop with a phase disabled and diff the
  marginal step time (the reference's vecmp.cpp t1..t4 phase table,
  part1/vecmp.cpp:25-32,178-183). :func:`timeit_steps` gives the marginal
  seconds per step, fenced by ``torch.cuda.synchronize()``.
- :func:`profile_steps` runs ``nsteps`` global steps of an engine from a
  carry under ``torch.profiler`` (CPU and CUDA activities) and returns the
  device time of every kernel by name, the window's wall time (host clock
  around work that ends in ``torch.cuda.synchronize()``) and the device idle
  share, ``1 - kernel time / wall time``. It needs a CUDA device: a window on
  the CPU measures nothing of the card.
- :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (the CLI's ``--trace``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, NamedTuple

import torch

__all__ = ["ProfileWindow", "profile_steps", "phase_times", "timeit_steps", "trace"]


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
    its ``_phase_disable`` flag (the JAX package's sharded seam). Any other
    engine raises TypeError: the port has no particle-list engine, whose
    phase seam differs."""
    from ppsim_tpu_torch.engines.grid import GridEngine
    from ppsim_tpu_torch.ops.grid_ops import RebinMonitors

    if not isinstance(engine, GridEngine):
        raise TypeError(f"engine {engine.name!r} has no phase seam: "
                        "phase_times needs a slab-family engine")
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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a GPU
    is present), written to ``log_dir/trace.json`` as a Chrome trace (open
    it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ProfileWindow(NamedTuple):
    steps: range  # the global steps profiled
    wall_ms: float
    kernel_ms: float  # summed device time of all kernels
    kernels: list  # [(name, device ms, calls), ...], largest first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.kernel_ms / self.wall_ms

    def table(self, top: int = 8) -> str:
        lines = [f"{'kernel':60s} {'device ms':>11s} {'share':>7s} {'calls':>6s}"]
        for name, ms, calls in self.kernels[:top]:
            lines.append(f"{name[:60]:60s} {ms:11.3f} "
                         f"{100 * ms / self.kernel_ms:6.2f}% {calls:6d}")
        lines.append(f"window {self.wall_ms:.3f} ms wall, {self.kernel_ms:.3f} "
                     f"ms kernels, device idle share {self.idle_share:.4f}")
        return "\n".join(lines)


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
    return carry, ProfileWindow(steps, wall_ms, kernel_ms, rows)
