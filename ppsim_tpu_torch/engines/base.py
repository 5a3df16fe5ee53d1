"""Engine protocol and the run driver (port of :mod:`ppsim_tpu.engines.base`).

The reference's driver owns the step loop and the save cadence
(part1/main.cpp:124-139): per step it calls ``simulate_one_step`` and saves
when ``step % savefreq == 0``, so the first frame is the state after one
step. The JAX package compiles that loop into ``lax.scan``s; here it is a
Python loop over device-resident state. Monitors stay device tensors until
the run ends, and so do the saved frames while they fit the run's frame
budget (``max_device_frame_bytes``, the JAX package's 2 GiB); past it each
frame streams to host memory as it is taken (:class:`FrameSink`). Nothing
inside the loop waits for the device, except a streamed run for the copy
of the frame two frames back.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Type

import numpy as np
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState

__all__ = ["Monitors", "Carry", "RunResult", "FrameSink", "Engine",
           "MAX_DEVICE_FRAME_BYTES", "register_engine", "get_engine",
           "engine_names", "resolve_device", "saved_frame_count"]

#: The saved run's frame budget on the device (the JAX package's
#: ``Engine.run`` default): past it the frames stream to host memory.
MAX_DEVICE_FRAME_BYTES = 2 << 30
#: Pinned host buffers a streamed run on the card cycles its copies through:
#: at most this many taken frames wait on the device for their copy.
FRAME_RING = 2


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


class Carry(NamedTuple):
    """The particle-list engines' carry: state in the engine's order (the
    binned engines keep it bin-sorted across steps) and each row's original
    index ``pid`` (int32), for id-order saves."""

    pos: torch.Tensor
    vel: torch.Tensor
    pid: torch.Tensor
    monitors: Monitors


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


def saved_frame_count(nsteps: int, savefreq: int, start: int = 0) -> int:
    """Frames a run of global steps ``start + 1 .. start + nsteps`` saves at
    the reference cadence (after steps ``i`` with ``(i - 1) % savefreq ==
    0``; none for ``savefreq <= 0``)."""
    if savefreq <= 0:
        return 0
    return max(0, (start + nsteps - 1) // savefreq - -(-start // savefreq) + 1)


class FrameSink:
    """The saved frames of one run, in the order taken; ``len`` counts them.

    Kept (``streams`` false): each frame stays a device tensor until
    :meth:`to_numpy` copies them one by one into one host array.

    Streamed: each frame goes to host memory as it is taken, and its device
    tensor is dropped. On the card an event recorded on the compute stream
    after the frame orders a copy on a stream of the sink's own, with
    ``non_blocking``, into the next of ``FRAME_RING`` pinned host buffers
    (a non-blocking copy into pageable memory would be synchronous); the
    host moves a buffer into the host array once the copy's own event has
    fired, and only then reuses it. Until then the sink holds the frame's
    device tensor: dropped earlier, the caching allocator would hand its
    memory to a later step while the copy still reads it. On the CPU a
    streamed frame is copied at once.

    The host array is one (F, N, ndim) tensor, F the frames the run can
    take (``count``), allocated at the first frame; :meth:`to_numpy`
    returns the rows taken as numpy.
    """

    def __init__(self, count: int, streams: bool):
        self.count = count
        self.streams = streams
        self._taken = 0
        self._host: Optional[torch.Tensor] = None
        self._kept: List[torch.Tensor] = []
        # streamed on the card: [pinned buffer, (row, frame, copied) or None]
        self._ring: List[list] = []
        self._copy_stream = None

    def __len__(self) -> int:
        return self._taken

    def add(self, frame: torch.Tensor) -> None:
        """Take the next frame (an (N, ndim) tensor the caller no longer
        writes)."""
        row = self._taken
        if self._host is None:
            self._host = torch.empty((self.count, *frame.shape), dtype=frame.dtype)
            if self.streams and frame.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(frame.device)
                self._ring = [[torch.empty(frame.shape, dtype=frame.dtype,
                                           pin_memory=True), None]
                              for _ in range(FRAME_RING)]
        self._taken += 1
        if not self.streams:
            self._kept.append(frame)
        elif not self._ring:
            self._host[row].copy_(frame)
        else:
            slot = self._ring[row % len(self._ring)]
            self._land(slot)
            self._copy_stream.wait_stream(torch.cuda.current_stream(frame.device))
            with torch.cuda.stream(self._copy_stream):
                slot[0].copy_(frame, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
            slot[1] = (row, frame, copied)

    def _land(self, slot) -> None:
        """Wait for the slot's copy, move its buffer into the host array and
        drop the frame's device tensor."""
        if slot[1] is not None:
            row, _, copied = slot[1]
            copied.synchronize()
            self._host[row].copy_(slot[0])
            slot[1] = None

    def flush(self) -> None:
        """Land every streamed frame in host memory (waits for their
        copies); kept frames stay on the device."""
        for slot in self._ring:
            self._land(slot)

    def to_numpy(self) -> Optional[np.ndarray]:
        """(F, N, ndim) frames on the host, or None if none were taken; kept
        frames are copied there one by one and dropped from the device."""
        if not self._taken:
            return None
        self.flush()
        for row, frame in enumerate(self._kept):
            self._host[row].copy_(frame)
        self._kept.clear()
        return self._host[:self._taken].numpy()


class Engine:
    """Base engine: subclasses implement the carry transforms; the base owns
    the run loop and the save cadence."""

    name: str = "base"
    supported_ndim = (2,)
    #: steps in one rebin period (the harness warms up one period); the
    #: particle-list engines rebin every step, the slab engines override it
    rebin_every = 1

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

    def repack_plan(self, nsteps: int):
        """The capacity-phase repack's window for the harness's timed runs:
        ``None`` (the default), or ``(min_steps, max_steps)``, after which the
        harness attempts a slot-capacity drop (``attempt_repack`` /
        ``commit_repack``). Consult it after the first ``init_carry`` (the
        packing measurement); only ``grid3d`` and ``cuda3d`` return one."""
        return None

    # ---- backend interface (defaults: the particle-list Carry) --------------
    def init_carry(self, state: ParticleState):
        n = state.num_parts
        return Carry(state.pos, state.vel,
                     torch.arange(n, dtype=torch.int32, device=state.device),
                     Monitors.zeros(state.device))

    def step_carry(self, carry):
        """One step of a particle-list engine."""
        raise NotImplementedError

    def step(self, carry, i: int):
        """Global step ``i`` (1-based) applied to ``carry``."""
        return self.step_carry(carry)

    def frame_of(self, carry) -> torch.Tensor:
        """(N, ndim) positions in original id order."""
        out = torch.empty_like(carry.pos)
        out[carry.pid] = carry.pos
        return out

    def final_state(self, carry) -> ParticleState:
        vel = torch.empty_like(carry.vel)
        vel[carry.pid] = carry.vel
        return ParticleState(self.frame_of(carry), vel)

    def monitors_of(self, carry) -> Monitors:
        return carry.monitors

    # ---- common driver -----------------------------------------------------
    def frame_sink(self, nsteps: int, savefreq: int, start: int = 0,
                   max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES) -> FrameSink:
        """The sink for the frames of ``run_steps(carry, nsteps, savefreq,
        start)``. It streams them to host memory when the JAX package's
        rule (``ppsim_tpu.engines.base.Engine.run``) finds the frame stack
        over the budget: ``max(1, nsteps // savefreq)`` frames of
        ``num_parts * ndim`` elements (the state's element size; the JAX
        package's 4 bytes in float32) above ``max_device_frame_bytes``."""
        cfg = self.config
        frame_bytes = cfg.num_parts * cfg.ndim * cfg.torch_dtype.itemsize
        streams = (savefreq > 0 and max(1, nsteps // savefreq) * frame_bytes
                   > max_device_frame_bytes)
        return FrameSink(saved_frame_count(nsteps, savefreq, start), streams)

    def run_steps(self, carry, nsteps: int, savefreq: int, start: int = 0,
                  after_step=None,
                  max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES):
        """Global steps ``start + 1 .. start + nsteps`` with frames after
        steps 1, 1+savefreq, ... (the reference cadence,
        part1/main.cpp:127-137; savefreq <= 0 saves none).
        ``after_step(carry, i)``, if given, runs after step ``i`` and before
        its frame, and returns ``(carry, stop)``; ``stop`` ends the run
        after step ``i``. Returns (carry, frames), frames the run's
        :class:`FrameSink` (:meth:`frame_sink` of the budget)."""
        frames = self.frame_sink(nsteps, savefreq, start, max_device_frame_bytes)
        for i in range(start + 1, start + nsteps + 1):
            carry = self.step(carry, i)
            stop = False
            if after_step is not None:
                carry, stop = after_step(carry, i)
            if savefreq > 0 and (i - 1) % savefreq == 0:
                frames.add(self.frame_of(carry))
            if stop:
                break
        return carry, frames

    def run(self, state: ParticleState, nsteps: Optional[int] = None,
            savefreq: int = 0,
            max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES) -> RunResult:
        """Run ``nsteps`` (default config.nsteps) saving every ``savefreq``
        steps (0 = never); returns once the device has finished. Frames
        past ``max_device_frame_bytes`` (:meth:`frame_sink`) stream to host
        memory as the run goes, as the JAX package's chunked saved runs do;
        within it they stay on the device until the run ends."""
        nsteps = self.config.nsteps if nsteps is None else nsteps
        carry = self.init_carry(state.to(self.device))
        carry, frames = self.run_steps(carry, nsteps, savefreq,
                                       max_device_frame_bytes=max_device_frame_bytes)
        return self.result_of(carry, frames, self.final_state(carry))

    def step_state(self, state: ParticleState) -> ParticleState:
        """One step, state in and state out (global step 1: the slab engines
        rebin on it only at cadence 1)."""
        return self.final_state(self.step(self.init_carry(state.to(self.device)), 1))

    def result_of(self, carry, frames: FrameSink, final: ParticleState) -> RunResult:
        """The run's result with monitors and frames copied to the host
        (waits for the device)."""
        monitors = self.monitors_of(carry).to_host()
        return RunResult(final, frames.to_numpy(), monitors, carry)


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
