"""CLI driver (port of :mod:`ppsim_tpu.harness`).

Keeps the reference's flags ``-n -o -s`` (part1/main.cpp:62-117), its summary
line ``Simulation Time = X seconds for N particles.`` (part1/main.cpp:147)
and its timing contract: the timer wraps engine setup (the slab pack, the
``init_simulation`` analog) and all steps, not particle initialization
(part1/main.cpp:118-143). Kernel builds, a warm-up run and the host-to-device
copy of the initial state happen before the timer starts; the timer stops
after ``torch.cuda.synchronize()``.

    python -m ppsim_tpu_torch -n 262144 -s 42 --steps 200 --engine cuda --check
    python -m ppsim_tpu_torch -n 20971520 -s 42 --engine cuda --grid-rebin-mode dirs9
    python -m ppsim_tpu_torch -n 20971520 --ndim 3 --density 7e-6 \
        --force-law lj --dt 1e-4 -s 42 --engine cuda3d
    python -m ppsim_tpu_torch -n 20971520 -s 42 --engine sharded_grid --shards 4
    torchrun --nproc-per-node 2 -m ppsim_tpu_torch -n 262144 --engine sharded_grid

Under ``torchrun`` (``WORLD_SIZE`` set) ``sharded_grid`` runs one shard a
process over ``torch.distributed`` (NCCL on the cards, gloo with ``--device
cpu``); every process runs the same program and rank 0 alone prints and
writes.
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
from ppsim_tpu_torch.initlib import init_particles
from ppsim_tpu_torch.io import MetricsWriter, write_trajectory
from ppsim_tpu_torch.profiling import trace
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
    p.add_argument("--steps", type=int, default=None, help="override nsteps (default 1000)")
    p.add_argument("--savefreq", type=int, default=None, help="override savefreq (default 10)")
    p.add_argument("--check", action="store_true",
                   help="run the absmin/absavg correctness checker on the run's frames")
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
                   help="sharded_grid: N row strips held in this process "
                        "(the JAX CLI's --cpu-mesh N; default 1, or one "
                        "process a shard under torchrun)")
    p.add_argument("--metrics", type=str, default=None, help="append a JSONL metrics record")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed run "
                        "to DIR/trace.json")
    return p


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(engine, state: ParticleState) -> None:
    """Untimed warm-up: build the kernels and run one rebin period (pack,
    rebin_every - 1 plain steps, one step with rebin), so every kernel and
    allocation the timed region uses has run once."""
    carry = engine.init_carry(state)
    carry, _ = engine.run_steps(carry, engine.rebin_every, 0)
    engine.final_state(carry)
    _sync(engine.device)


def timed_run_repeats(engine, state: ParticleState, nsteps: int, savefreq: int,
                      repeats: int = 1):
    """Run ``repeats`` times under the reference timing contract: the pack
    (``init_carry``), all steps and the final gather inside the timer; the
    host-to-device copy of the initial state and a warm-up outside it.
    Returns ``(RunResult, [seconds, ...])``; frames and monitors are copied
    to the host after the last timer stops."""
    state = state.to(engine.device)
    warm_up(engine, state)
    times = []
    for _ in range(max(1, repeats)):
        _sync(engine.device)
        t0 = time.perf_counter()
        carry = engine.init_carry(state)
        carry, frames = engine.run_steps(carry, nsteps, savefreq)
        final = engine.final_state(carry)
        _sync(engine.device)
        times.append(time.perf_counter() - t0)
    return engine.result_of(carry, frames, final), times


def timed_run(engine, state: ParticleState, nsteps: int, savefreq: int):
    """Single-shot :func:`timed_run_repeats` (the reference times exactly one
    run). Auto-capacity engines self-heal on dropped particles here too: the
    engine raises its capacity and the run restarts from the initial state;
    the reported time is the last (clean) attempt's."""
    result, times = timed_run_repeats(engine, state, nsteps, savefreq)
    for _try in range(2):
        if not engine.maybe_escalate_after_drop(result):
            break
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
    return SimConfig(num_parts=args.n, ndim=args.ndim,
                     force_law=args.force_law, **kw)


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
        if engine_name != "sharded_grid":
            parser.error("--shards applies to --engine sharded_grid")
        options["shards"] = args.shards
    try:
        engine = get_engine(engine_name, config, device=args.device, **options)
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
            "nsteps": nsteps,
            "seed": args.s,
            "savefreq": effective_savefreq,
            "seconds": seconds,
            "particle_steps_per_sec": args.n * nsteps / seconds,
            "timing_contract": "includes slab pack + steps + final gather; "
                               "excludes kernel build, warm-up, particle init "
                               "and the host-to-device copy",
            "max_bin_count": int(result.monitors.max_bin_count),
            "migrate_dropped": int(result.monitors.migrate_dropped),
            "capacity": engine.capacity,
            "device": device_name(engine.device),
            **check_rec,
        }
    )
    return 0 if check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
