"""CLI driver (port of :mod:`ppsim_tpu.harness`).

Keeps the reference's flags ``-n -o -s`` (part1/main.cpp:62-117), its summary
line ``Simulation Time = X seconds for N particles.`` (part1/main.cpp:147)
and its timing contract: the timer wraps engine setup (``init_carry``: the
slab pack, or the sharded engine's strip split, the ``init_simulation``
analog) and all steps, not particle initialization
(part1/main.cpp:118-143). Kernel builds, a warm-up run and the host-to-device
copy of the initial state happen before the timer starts; the timer stops
after ``torch.cuda.synchronize()``. Saved frames (``-o``, ``--check``) within
the 2 GiB frame budget are copied to the host after the timer stops; past
it they stream to host memory inside the timer (``timed_run_repeats``).

    python -m ppsim_tpu_torch -n 262144 -s 42 --steps 200 --engine cuda --check
    python -m ppsim_tpu_torch -n 20971520 -s 42 --engine cuda --grid-rebin-mode dirs9
    python -m ppsim_tpu_torch -n 20971520 --ndim 3 --density 7e-6 \
        --force-law lj --dt 1e-4 -s 42 --engine cuda3d
    python -m ppsim_tpu_torch -n 20971520 --ndim 3 --density 7e-6 -s 42 \
        --grid3-spill 0 --grid3-repack 1 --engine cuda3d
    python -m ppsim_tpu_torch -n 262144 -s 42 --steps 400 --checkpoint-out a.npz
    python -m ppsim_tpu_torch -n 262144 --steps 600 --resume a.npz
    python -m ppsim_tpu_torch -n 20971520 -s 42 --engine sharded_grid --shards 4
    python -m ppsim_tpu_torch -n 20971520 --ndim 3 --density 7e-6 \
        --force-law lj --dt 1e-4 -s 42 --engine sharded_grid3d --shards 4
    python -m ppsim_tpu_torch -n 20971520 -s 42 --engine sharded_tile --shards 4
    python -m ppsim_tpu_torch -n 262144 -s 42 --steps 200 --engine binned --check
    python -m ppsim_tpu_torch -n 1024 -s 42 --engine oracle --dtype float64
    python -m ppsim_tpu_torch -n 262144 -s 42 --engine sharded --shards 4
    torchrun --nproc-per-node 2 -m ppsim_tpu_torch -n 262144 --engine sharded_grid

Under ``torchrun`` (``WORLD_SIZE`` set) ``sharded``, ``sharded_grid``,
``sharded_grid3d`` and ``sharded_tile`` (on the near-square mesh of the
world size) run one shard a process over ``torch.distributed`` (NCCL on the
cards, gloo with ``--device cpu``); every process runs the same program and
rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch
import torch.distributed as dist

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.engines import engine_names, get_engine
from ppsim_tpu_torch.engines.base import MAX_DEVICE_FRAME_BYTES
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.io import (
    MetricsWriter, load_checkpoint, save_checkpoint, write_trajectory,
)
from ppsim_tpu_torch.profiling import span, trace
from ppsim_tpu_torch.state import ParticleState

__all__ = ["main", "timed_run", "timed_run_repeats", "build_parser",
           "config_from_args", "device_name"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppsim_tpu_torch",
        description="Parallel particle simulation, PyTorch + Hopper kernels",
        allow_abbrev=False,
    )
    # Reference flags (part1/main.cpp:95-117)
    p.add_argument("-n", type=int, default=1000, help="set number of particles")
    p.add_argument("-o", type=str, default=None, help="set the output file name")
    p.add_argument("-s", type=int, default=0, help="set particle initialization seed")
    p.add_argument("--engine", default=None,
                   help=" | ".join(engine_names()) + " (default cuda, or "
                        "cuda3d with --ndim 3)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (default cuda; cuda without a "
                        "GPU is an error, never a silent CPU run)")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"),
                   help="float type of the state (float64: the particle-list "
                        "engines oracle, binned, binned3d, sharded; the slab "
                        "engines are float32-only)")
    p.add_argument("--steps", type=int, default=None, help="override nsteps (default 1000)")
    p.add_argument("--savefreq", type=int, default=None, help="override savefreq (default 10)")
    p.add_argument("--check", action="store_true",
                   help="run the absmin/absavg correctness checker on the run's frames")
    p.add_argument("--checkpoint-out", type=str, default=None,
                   help="write a full-state checkpoint (.npz) after the run")
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint instead of initializing")
    p.add_argument("--ndim", type=int, default=2, choices=(2, 3),
                   help="2 (reference physics) or 3 (the stretch config; "
                        "engines: " + ", ".join(engine_names(3)) + ")")
    p.add_argument("--density", type=float, default=None,
                   help="box measure per particle (default 0.0005; 3D runs "
                        "want ~7e-6)")
    p.add_argument("--force-law", default="repulsive", choices=("repulsive", "lj"),
                   help="repulsive (reference) | lj (truncated Lennard-Jones)")
    p.add_argument("--dt", type=float, default=None,
                   help="override the timestep (default 0.0005; LJ runs want "
                        "~1e-4)")
    p.add_argument("--bin-scale", type=float, default=2.0,
                   help="particle-list engines: bin side / cutoff")
    p.add_argument("--bin-capacity", type=int, default=8,
                   help="particle-list engines: max particles per bin")
    p.add_argument("--rebin-every", type=int, default=None,
                   help="rebin cadence in steps (default from config; routes "
                        "to the active --ndim family)")
    p.add_argument("--grid-capacity", type=int, default=None,
                   help="slots per bin (default auto; a hand value disables "
                        "the drop-detected capacity escalation; routes to "
                        "the active --ndim family)")
    p.add_argument("--grid-bin-scale", type=float, default=None,
                   help="bin side / cutoff (default from config; routes to "
                        "the active --ndim family)")
    p.add_argument("--grid3-bin-scale", type=float, default=None,
                   help="3D engines: bin side / cutoff (explicit 3D form)")
    p.add_argument("--grid3-capacity", type=int, default=None,
                   help="3D engines: slots per bin (default auto: anisotropy "
                        "and LJ-floor headroom plus drop-detected escalation; "
                        "a hand value disables both)")
    p.add_argument("--rebin3-every", type=int, default=None,
                   help="3D engines: rebin cadence in steps (default auto "
                        "from the geometry's slack)")
    p.add_argument("--grid3-spill", type=int, default=None, choices=(0, 1),
                   help="3D engines: park the t=0 packing overflow one bin "
                        "over instead of raising capacity (default auto: on "
                        "with auto capacity)")
    p.add_argument("--grid3-repack", type=int, default=None, choices=(0, 1),
                   help="3D grid engines: capacity-phase repack (prologue at "
                        "the t=0 packing capacity, verified repack down to "
                        "the run capacity). Default auto: on for the "
                        "repulsive law, off for lj")
    p.add_argument("--grid3-prologue-steps", type=int, default=None,
                   help="3D grid engines: steps before the first repack "
                        "attempt (default auto)")
    p.add_argument("--grid-rebin-mode", default=None, choices=("dirs9", "axes"),
                   help="2D grid engines: rebin algorithm (axes = the "
                        "axis-factorized default; dirs9 = the 9-direction "
                        "shuffle, the ablation)")
    p.add_argument("--grid-snap-lanes", type=int, default=None, choices=(0, 1),
                   help="score lane-exact bin counts with the geometry cost "
                        "model (default on; see SlabGeometry.for_config)")
    p.add_argument("--init", default="auto", choices=("auto", "reference", "fast"),
                   help="particle initializer: reference (2D, bit-faithful), "
                        "fast (seeded lattice on the engine's device, 2D or "
                        "3D) or auto (reference in 2D, fast in 3D; a random "
                        "seed for -s 0)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="sharded / sharded_grid / sharded_grid3d: N row (y) "
                        "strips, "
                        "sharded_tile: N tiles on the near-square mesh, "
                        "held in this process "
                        "(the JAX CLI's --cpu-mesh N; default 1, or one "
                        "process a shard under torchrun)")
    p.add_argument("--metrics", type=str, default=None, help="append a JSONL metrics record")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed run, "
                        "the program's ppsim.* spans over its operations and "
                        "kernels, to DIR/trace.json")
    return p


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _repack(engine, carry):
    """One repack attempt, committed if it overflowed nothing. Returns
    ``(carry, committed)``; a failed attempt returns the carry as it was."""
    carry, overflow = engine.attempt_repack(carry)
    if overflow == 0:
        engine.commit_repack()
    return carry, overflow == 0


def discover_repack(engine, carry, nsteps: int, plan):
    """The repack's discovery pass from ``carry`` (the packed initial
    state), ``plan = (min_s, max_s)`` from ``engine.repack_plan``: an
    attempt after every step ``i`` that is a multiple of the rebin cadence
    with ``min_s <= i < nsteps``, while ``i <= max_s`` or no attempt has
    been made, until one commits. It stops at the commit or the last
    attempt: a capacity change builds nothing new, so later steps would
    warm nothing. Returns ``(carry, done, attempts, switch_step)``, the
    carry after step ``done``, the last attempt's."""
    cadence = engine.rebin_every
    min_s, max_s = plan
    first = -(-min_s // cadence) * cadence
    if first >= nsteps:
        return carry, 0, [], None
    attempts, switched = [], []

    def attempt(carry, i):
        if i < first or i % cadence:
            return carry, False
        attempts.append(i)
        carry, committed = _repack(engine, carry)
        if committed:
            switched.append(i)
        later = i + cadence
        return carry, committed or later > max_s or later >= nsteps

    carry, _ = engine.run_steps(carry, nsteps - 1, 0, after_step=attempt)
    return carry, attempts[-1], attempts, (switched[0] if switched else None)


def run_switched(engine, carry, nsteps: int, savefreq: int, switch_at=None,
                 max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES):
    """``engine.run_steps`` with the committing repack replayed after step
    ``switch_at`` (None: no repack), before that step's frame."""
    def replay(carry, i):
        if i == switch_at:
            carry, _ = _repack(engine, carry)
        return carry, False

    return engine.run_steps(carry, nsteps, savefreq,
                            after_step=None if switch_at is None else replay,
                            max_device_frame_bytes=max_device_frame_bytes)


def timed_run_repeats(engine, state: ParticleState, nsteps: int, savefreq: int,
                      repeats: int = 1,
                      max_device_frame_bytes: int = MAX_DEVICE_FRAME_BYTES):
    """Run ``repeats`` times under the reference timing contract: the pack
    (``init_carry``), all steps and the final gather inside the timer; the
    host-to-device copy of the initial state and a warm-up outside it.
    Returns ``(RunResult, [seconds, ...])`` of the last run.

    Saved frames follow ``Engine.run``'s budget (``engine.frame_sink``), as
    the JAX package's two saved-run paths do. Within ``max_device_frame_bytes``
    they stay on the device and are copied to the host after the timer
    stops, as from the JAX package's one saved program. Past it they stream
    to host memory as the run goes and all have landed there when the timer
    stops, as in the JAX package's chunked saved runs and the reference's
    ``-o`` runs (part1/main.cpp:132-137). Monitors are copied after the
    timer.

    The warm-up builds the kernels and runs one rebin period (pack,
    rebin_every - 1 plain steps, one step with rebin) and, for a saved run,
    takes one frame into a sink of the run's kind, so every kernel and
    allocation the timed region uses has run once (the pinned buffers of a
    streamed run then come from the host allocator's cache). With a
    capacity-phase repack (``engine.repack_plan``, consulted after the
    first pack) the discovery pass (:func:`discover_repack`) comes first,
    and the rebin period follows it at the capacity it ended at; it records
    the steps it attempted at and the one that committed in
    ``engine._last_repack_attempts`` and ``engine._last_repack_switch``
    (runs are deterministic). The timed runs replay the committing attempt
    alone, its wait for the overflow included."""
    state = state.to(engine.device)
    carry = engine.init_carry(state)  # the first call measures the packing
    plan = engine.repack_plan(nsteps)
    done, switch_at = 0, None
    if plan is not None:
        carry, done, attempts, switch_at = discover_repack(engine, carry, nsteps, plan)
        engine._last_repack_attempts, engine._last_repack_switch = attempts, switch_at
    carry, _ = engine.run_steps(carry, engine.rebin_every, 0, start=done)
    engine.final_state(carry)
    if savefreq > 0:
        warm = engine.frame_sink(nsteps, savefreq,
                                 max_device_frame_bytes=max_device_frame_bytes)
        warm.add(engine.frame_of(carry))
        warm.to_numpy()
        del warm
    _sync(engine.device)
    del carry
    times = []
    for _ in range(max(1, repeats)):
        carry = frames = None  # the last run's slab and frames go first
        _sync(engine.device)
        t0 = time.perf_counter()
        with span("ppsim.pack"):
            carry = engine.init_carry(state)
        carry, frames = run_switched(engine, carry, nsteps, savefreq, switch_at,
                                     max_device_frame_bytes)
        with span("ppsim.gather"):
            final = engine.final_state(carry)
        frames.flush()
        _sync(engine.device)
        times.append(time.perf_counter() - t0)
    return engine.result_of(carry, frames, final), times


def timed_run(engine, state: ParticleState, nsteps: int, savefreq: int):
    """Single-shot :func:`timed_run_repeats` (the reference times exactly one
    run). Auto-capacity engines self-heal on dropped particles here too: the
    engine raises its capacity and the run restarts from the initial state;
    the reported time is the last (clean) attempt's; ``engine.counters``
    count the re-runs and the steps they discarded."""
    steps_before = engine.counters.steps_run
    result, times = timed_run_repeats(engine, state, nsteps, savefreq)
    for _try in range(2):
        if not engine.maybe_escalate_after_drop(result):
            break
        engine.counters.note_rerun(steps_before)
        steps_before = engine.counters.steps_run
        result, times = timed_run_repeats(engine, state, nsteps, savefreq)
    return result, times[0]


def config_from_args(args) -> SimConfig:
    """The run's SimConfig. The generic ``--grid-*`` flags tune the family
    that ``--ndim`` selects; the ``--grid3-*`` spellings win on conflict."""
    family = ("grid3_bin_scale", "grid3_capacity", "rebin3_every") \
        if args.ndim == 3 else ("grid_bin_scale", "grid_capacity", "rebin_every")
    pairs = tuple(zip(family, (args.grid_bin_scale, args.grid_capacity,
                               args.rebin_every))) + (
        ("grid3_bin_scale", args.grid3_bin_scale),
        ("grid3_capacity", args.grid3_capacity),
        ("rebin3_every", args.rebin3_every),
        ("density", args.density),
        ("dt", args.dt),
    )
    kw = {k: v for k, v in pairs if v is not None}
    if args.grid_snap_lanes is not None:
        kw["grid_snap_lanes"] = bool(args.grid_snap_lanes)
    if args.grid_rebin_mode is not None:
        kw["grid_rebin_mode"] = args.grid_rebin_mode
    if args.grid3_spill is not None:
        kw["grid3_spill"] = bool(args.grid3_spill)
    if args.grid3_repack is not None:
        kw["grid3_repack"] = bool(args.grid3_repack)
    if args.grid3_prologue_steps is not None:
        kw["grid3_prologue_steps"] = args.grid3_prologue_steps
    return SimConfig(num_parts=args.n, ndim=args.ndim, force_law=args.force_law,
                     dtype=args.dtype, bin_scale=args.bin_scale,
                     bin_capacity=args.bin_capacity, **kw)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    config = config_from_args(args)
    nsteps = args.steps if args.steps is not None else config.nsteps
    # Reference cadence: frames are saved only when they are needed.
    savefreq = args.savefreq if args.savefreq is not None else config.savefreq
    if (args.o or args.check) and savefreq <= 0:
        parser.error("-o/--check need saved frames: --savefreq must be >= 1")
    effective_savefreq = savefreq if (args.o or args.check) else 0

    engine_name = args.engine or ("cuda3d" if args.ndim == 3 else "cuda")
    options = {}
    if args.shards is not None:
        if engine_name not in ("sharded", "sharded_grid", "sharded_grid3d", "sharded_tile"):
            parser.error("--shards applies to --engine sharded, sharded_grid, "
                         "sharded_grid3d or sharded_tile")
        options["shards"] = args.shards
    try:
        engine = get_engine(engine_name, config, device=args.device, **options)
        start_step = 0
        if args.resume:
            state, start_step, _ = load_checkpoint(args.resume, device=engine.device)
            if tuple(state.pos.shape) != (config.num_parts, config.ndim):
                parser.error(f"--resume {args.resume} holds positions of shape "
                             f"{tuple(state.pos.shape)}; -n {config.num_parts} "
                             f"--ndim {config.ndim} needs "
                             f"({config.num_parts}, {config.ndim})")
            state = state.to(dtype=config.torch_dtype)
        else:
            state = init_particles(config, seed=args.s, method=args.init,
                                   device=engine.device)
        with trace(args.trace) if args.trace else contextlib.nullcontext():
            result, seconds = timed_run(engine, state, nsteps, effective_savefreq)
        engine.check(result)
    finally:
        distributed = dist.is_initialized()
        rank = dist.get_rank() if distributed else 0
        if distributed:
            dist.destroy_process_group()
    if rank != 0:
        return 0

    if args.o:
        write_trajectory(args.o, result.frames, config.size)
    if args.checkpoint_out:
        save_checkpoint(args.checkpoint_out, result.state, start_step + nsteps, config)

    # The benchmark interface line (part1/main.cpp:147) — keep byte format.
    print(f"Simulation Time = {seconds:g} seconds for {args.n} particles.")

    check_ok = True
    check_rec = {}
    if args.check:
        from ppsim_tpu_torch.checker import check_frames

        cres = check_frames(result.frames, config)
        print(f"Correctness check: {cres}")
        check_ok = cres.passed
        check_rec = {
            "check_passed": bool(cres.passed),
            "check_absmin": float(cres.absmin),
            "check_absavg": float(cres.absavg),
        }

    MetricsWriter(args.metrics).emit(
        {
            "engine": engine_name,
            "num_parts": args.n,
            "ndim": args.ndim,
            "force_law": args.force_law,
            "dtype": args.dtype,
            "nsteps": nsteps,
            "seed": args.s,
            "savefreq": effective_savefreq,
            "seconds": seconds,
            "particle_steps_per_sec": args.n * nsteps / seconds,
            "timing_contract": "includes init_carry (slab pack) + steps + final gather "
                               "+ frames streamed past the 2 GiB frame budget; "
                               "excludes kernel build, warm-up, particle init "
                               "and the host-to-device copy",
            "max_bin_count": int(result.monitors.max_bin_count),
            "migrate_dropped": int(result.monitors.migrate_dropped),
            "capacity": engine.capacity,
            "device": device_name(engine.device),
            **engine.counters.record(),
            **check_rec,
        }
    )
    return 0 if check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
