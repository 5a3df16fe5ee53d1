"""Engine protocol and the run driver (port of :mod:`ppsim_tpu.engines.base`).

The reference's driver owns the step loop and the save cadence
(part1/main.cpp:124-139): per step it calls ``simulate_one_step`` and saves
when ``step % savefreq == 0``, so the first frame is the state after one
step. The JAX package compiles that loop into ``lax.scan``s; here it is a
Python loop over device-resident state. Monitors and frames stay device
tensors until the run ends: nothing inside the loop waits for the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Type

import numpy as np
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState

__all__ = ["Monitors", "RunResult", "Engine", "register_engine", "get_engine",
           "engine_names", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises
    (a measurement path never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                               "available (torch.cuda.is_available() is False)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


class Monitors(NamedTuple):
    """Safety counters accumulated across the run (0-dim device tensors;
    host-side numpy scalars in a RunResult).

    ``max_bin_count`` — running max bin occupancy (> capacity: dropped).
    ``migrate_dropped`` — particles lost (the rebin's ``dropped``: structural
    loss or far movers).
    ``max_speed`` — float32 running max speed; stale binning is valid only
    while ``rebin_every * max_speed * dt <= grid_slack``.
    ``deferred`` — leavers kept in their old bin for one rebin (non-fatal).
    """

    max_bin_count: torch.Tensor
    migrate_dropped: torch.Tensor
    max_speed: torch.Tensor
    deferred: torch.Tensor

    @staticmethod
    def zeros(device) -> "Monitors":
        z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
        return Monitors(z(torch.int32), z(torch.int32), z(torch.float32),
                        z(torch.int32))

    def merge(self, other: "Monitors") -> "Monitors":
        return Monitors(
            torch.maximum(self.max_bin_count, other.max_bin_count),
            self.migrate_dropped + other.migrate_dropped,
            torch.maximum(self.max_speed, other.max_speed),
            self.deferred + other.deferred,
        )

    def to_host(self) -> "Monitors":
        return Monitors(*(np.asarray(t.cpu().numpy()) for t in self))


class RunResult(NamedTuple):
    state: ParticleState  # final state, id order (device tensors)
    frames: Optional[np.ndarray]  # (F, N, ndim) saved positions, id order
    monitors: Monitors  # host-side values
    carry: Any = None  # the engine's final carry (e.g. the slab), device-side

    def check(self, config: SimConfig, capacity: Optional[int] = None) -> None:
        """Raise if any safety monitor tripped."""
        cap = config.bin_capacity if capacity is None else capacity
        mx = int(self.monitors.max_bin_count)
        if mx > cap:
            raise RuntimeError(
                f"bin overflow: max occupancy {mx} > capacity {cap}; "
                "rerun with a larger bin capacity"
            )
        dropped = int(self.monitors.migrate_dropped)
        if dropped:
            raise RuntimeError(
                f"{dropped} particles dropped; increase evac_capacity"
            )
        max_speed = float(self.monitors.max_speed)
        if max_speed > 0.0:
            drift = config.rebin_every * max_speed * config.dt
            if drift > config.grid_slack:
                raise RuntimeError(
                    f"stale-bin slack violated: rebin_every*max|v|*dt = {drift:.4g} "
                    f"> slack {config.grid_slack:.4g}; lower rebin_every or raise "
                    "grid_bin_scale"
                )


class Engine:
    """Base engine: subclasses implement the carry transforms; the base owns
    the run loop and the save cadence."""

    name: str = "base"
    supported_ndim = (2,)

    def __init__(self, config: SimConfig, device="cuda"):
        config.validate()
        if config.ndim not in self.supported_ndim:
            raise ValueError(
                f"engine {self.name!r} supports ndim in {self.supported_ndim}, "
                f"got ndim={config.ndim}; engines for ndim={config.ndim}: "
                f"{', '.join(engine_names(config.ndim))}"
            )
        self.config = config
        self.device = resolve_device(device)

    @property
    def capacity(self) -> int:
        return self.config.bin_capacity

    def check(self, result: RunResult) -> None:
        result.check(self.config, capacity=self.capacity)

    def maybe_escalate_after_drop(self, result: RunResult) -> bool:
        """Engines that can grow their slot capacity after a dropped-particle
        run override this to do so and return True (the caller re-runs)."""
        return False

    # ---- backend interface -------------------------------------------------
    def init_carry(self, state: ParticleState):
        raise NotImplementedError

    def step(self, carry, i: int):
        """Global step ``i`` (1-based) applied to ``carry``."""
        raise NotImplementedError

    def frame_of(self, carry) -> torch.Tensor:
        """(N, ndim) positions in original id order."""
        raise NotImplementedError

    def final_state(self, carry) -> ParticleState:
        raise NotImplementedError

    def monitors_of(self, carry) -> Monitors:
        return carry.monitors

    # ---- common driver -----------------------------------------------------
    def run_steps(self, carry, nsteps: int, savefreq: int):
        """``nsteps`` steps with frames after steps 1, 1+savefreq, ... (the
        reference cadence, part1/main.cpp:127-137; savefreq <= 0 saves
        none). Returns (carry, frames) with frames a list of device tensors."""
        frames: List[torch.Tensor] = []
        for i in range(1, nsteps + 1):
            carry = self.step(carry, i)
            if savefreq > 0 and (i - 1) % savefreq == 0:
                frames.append(self.frame_of(carry))
        return carry, frames

    def run(self, state: ParticleState, nsteps: Optional[int] = None,
            savefreq: int = 0) -> RunResult:
        """Run ``nsteps`` (default config.nsteps) saving every ``savefreq``
        steps (0 = never); returns once the device has finished."""
        nsteps = self.config.nsteps if nsteps is None else nsteps
        carry = self.init_carry(state.to(self.device))
        carry, frames = self.run_steps(carry, nsteps, savefreq)
        return self.result_of(carry, frames, self.final_state(carry))

    def result_of(self, carry, frames, final: ParticleState) -> RunResult:
        """The run's result with monitors and frames copied to the host
        (waits for the device)."""
        monitors = self.monitors_of(carry).to_host()
        frames_np = torch.stack(frames).cpu().numpy() if frames else None
        return RunResult(final, frames_np, monitors, carry)


_REGISTRY: Dict[str, Type[Engine]] = {}


def register_engine(cls: Type[Engine]) -> Type[Engine]:
    _REGISTRY[cls.name] = cls
    return cls


def get_engine(name: str, config: SimConfig, device="cuda", **options) -> Engine:
    """Engine ``name`` for ``config`` on ``device``: the card unless the
    caller asks for the CPU (``cuda`` without a GPU raises). ``options`` go
    to the engine (``sharded_grid``: ``shards``, ``mesh``, ``impl``)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; have {sorted(_REGISTRY)}") from None
    return cls(config, device=device, **options)


def engine_names(ndim: Optional[int] = None) -> list:
    """Registered engine names in registration order, optionally only those
    supporting ``ndim``."""
    return [name for name, cls in _REGISTRY.items()
            if ndim is None or ndim in cls.supported_ndim]
