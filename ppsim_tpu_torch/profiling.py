"""Where the device time goes: a ``torch.profiler`` window over engine steps.

:func:`profile_steps` runs ``nsteps`` global steps of an engine from a carry
under ``torch.profiler`` (CPU and CUDA activities) and returns the device
time of every kernel by name, the window's wall time (host clock around
work that ends in ``torch.cuda.synchronize()``) and the device idle share,
``1 - kernel time / wall time``. It needs a CUDA device: a window on the CPU
measures nothing of the card.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

__all__ = ["ProfileWindow", "profile_steps"]


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
