#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/Hopper port (``ppsim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its result and seconds on its own line:

0. the card (nvidia-smi name and power limit, torch's device name) and the
   kernel build from ``ppsim_tpu_torch/csrc`` (nvcc, sm_90a);
1. each kernel against its plain PyTorch twin on the card: K1 (fused step)
   allclose and K2 (rebin) bitwise at the main-path shape (n = 20,971,520:
   1664 x 1664 bins, capacity 14), K2 also on a padded geometry and on a
   contention slab; kernel and plain times with CUDA events; and the ``cuda``
   engine against the plain ``grid`` engine on a small run;
2. the CLI end to end: ``python -m ppsim_tpu_torch -n 262144 -s 42 --steps 200
   --engine cuda --check`` must print the summary line and a checker PASS;
3. the main path at full width: n = 20,971,520, 1000 steps, rebin cadence 11,
   engine ``cuda``, unsaved, through ``harness.timed_run``; the monitors must
   pass, every pid must sit in exactly one slot of the final slab, and both
   kernels must have launched.

The line before the last is a JSON object with each kernel's launches in the
phase-3 run, its largest difference from the plain twin, and its time beside
the plain twin's; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero without that line. Without a CUDA device
the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_MAIN = 20_971_520  # bench.py's 2D headline size
STEPS_MAIN = 1000
CADENCE_MAIN = 11  # bench.py TUNED_CADENCE
SEED = 42
# K1 parity: owner-computes sums in the plain twin's order, but rsqrtf and FMA
# contraction move the last bits of the pair sums; accelerations reach ~1e4
# in close encounters, so velocities carry ~1e-7 relative error.
K1_RTOL, K1_ATOL = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_line(name: str, result: str, t0: float) -> None:
    log(f"[phase {name}] {result} ({time.perf_counter() - t0:.3f} s)")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def max_abs_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def assert_close(name, got, want, rtol, atol) -> float:
    """allclose or raise; returns the max abs difference."""
    import torch

    err = max_abs_diff(got, want)
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: not allclose (rtol={rtol}, atol={atol}); "
                             f"max abs diff {err:.3e}")
    return err


def assert_equal(name, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} elements differ (bitwise parity)")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, CUDA events around ``reps`` calls
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def k1_compare(name, slab, geom, cfg) -> float:
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain

    args = (slab.xl, slab.yl, slab.vx, slab.vy, geom, cfg.cutoff, cfg.min_r,
            cfg.mass, cfg.dt, cfg.size)
    got = grid_step_cuda(*args)
    want = grid_step_plain(*args)
    errs = [assert_close(f"K1 {name} {p}", g, w, K1_RTOL, K1_ATOL)
            for p, g, w in zip(("xl", "yl", "vx", "vy", "speed2"), got, want)]
    log(f"  K1 {name}: allclose (rtol {K1_RTOL:g}, atol {K1_ATOL:g}); max abs "
        f"diff xl {errs[0]:.3e} yl {errs[1]:.3e} vx {errs[2]:.3e} "
        f"vy {errs[3]:.3e} speed2 {errs[4]:.3e}")
    return max(errs)


def k2_compare(name, slab, geom, evac) -> None:
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_axes_call_cuda, rebin_axes_call_plain,
    )
    from ppsim_tpu_torch.ops.grid_ops import monitors_of_counts

    got, gcnt = rebin_axes_call_cuda(slab, geom, evac)
    want, wcnt = rebin_axes_call_plain(slab, geom, evac)
    for f, g, w in zip(got._fields, got, want):
        assert_equal(f"K2 {name} {f}", g, w)
    assert_equal(f"K2 {name} count planes", gcnt, wcnt)
    mon = [int(v) for v in monitors_of_counts(gcnt)]
    moved = int((got.pid != slab.pid).sum())
    log(f"  K2 {name}: bitwise equal on 5 planes + 4 count planes; "
        f"slots changed {moved}; monitors (max_occ, dropped, deferred) {mon}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ppsim_tpu_torch import _build
    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_axes_call_cuda, rebin_axes_call_plain,
    )
    from ppsim_tpu_torch.testing import STRESS_GEOMETRY, stress_slab

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels = {
        "grid_step": {"name": "grid_step", "route": "cuda",
                      "source": "ppsim_tpu_torch/csrc/grid_step.cu",
                      "replaces": "ppsim_tpu/ops/pallas_grid.py:340",
                      "wrapper": grid_step_cuda},
        "rebin_axes": {"name": "rebin_axes", "route": "cuda",
                       "source": "ppsim_tpu_torch/csrc/rebin_axes.cu",
                       "replaces": "ppsim_tpu/ops/pallas_rebin.py:370",
                       "wrapper": rebin_axes_call_cuda},
    }

    # ---- phase 0: the card and the build ---------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name!r} "
        f"count {torch.cuda.device_count()}")
    tb = time.perf_counter()
    _build.kernels()
    log(f"kernel build/load: {time.perf_counter() - tb:.1f} s")
    for line in _build.kernel_build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    phase_line("0", "card and kernels ready", t0)

    cfg = SimConfig(num_parts=N_MAIN, rebin_every=CADENCE_MAIN)
    ti = time.perf_counter()
    state = init_particles(cfg, seed=SEED, method="reference", device=dev)
    log(f"init_particles_reference(n={N_MAIN}, seed={SEED}): "
        f"{time.perf_counter() - ti:.1f} s")

    # ---- phase 1: kernels against their plain twins on the card ----------
    t0 = time.perf_counter()
    eng = get_engine("cuda", cfg, device=dev)
    geom = eng.geom
    log(f"  main-path geometry: {geom.rows}x{geom.cols} bins (padded "
        f"{geom.rows_pad}x{geom.cols_pad}), capacity {geom.capacity}, "
        f"bin size {geom.bin_size:.6g}")
    if (geom.rows, geom.cols, geom.capacity) != (1664, 1664, 14):
        raise AssertionError(f"unexpected main-path geometry {geom}")
    slab0 = eng.init_carry(state).slab
    err0 = k1_compare("init slab", slab0, geom, cfg)
    carry = eng.init_carry(state)
    for _ in range(CADENCE_MAIN):
        carry = eng.step_plain(carry)
    slab11 = carry.slab
    del carry
    err11 = k1_compare(f"after {CADENCE_MAIN} steps", slab11, geom, cfg)
    kernels["grid_step"]["max_abs_err"] = max(err0, err11)
    k2_compare(f"after {CADENCE_MAIN} steps", slab11, geom, cfg.evac_capacity)

    cfg_pad = SimConfig(num_parts=262_144)
    eng_pad = get_engine("cuda", cfg_pad, device=dev)
    gp = eng_pad.geom
    log(f"  padded geometry: {gp.rows}x{gp.cols} in {gp.rows_pad}x"
        f"{gp.cols_pad}, capacity {gp.capacity}")
    carry = eng_pad.init_carry(init_particles(cfg_pad, seed=SEED, device=dev))
    for _ in range(cfg_pad.rebin_every):
        carry = eng_pad.step_plain(carry)
    k2_compare("padded geometry", carry.slab, gp, cfg_pad.evac_capacity)

    gs = STRESS_GEOMETRY
    k2_compare("contention slab", stress_slab(gs, 0, 2, dev), gs, 2)
    kernels["rebin_axes"]["max_abs_err"] = 0.0

    # times at the main-path shape: plain, kernel, kernel, plain
    k1_args = (slab11.xl, slab11.yl, slab11.vx, slab11.vy, geom, cfg.cutoff,
               cfg.min_r, cfg.mass, cfg.dt, cfg.size)
    k2_args = (slab11, geom, cfg.evac_capacity)
    p1 = cuda_ms(lambda: grid_step_plain(*k1_args), 3)
    k1a = cuda_ms(lambda: grid_step_cuda(*k1_args), 20)
    k2a = cuda_ms(lambda: rebin_axes_call_cuda(*k2_args), 20)
    p2 = cuda_ms(lambda: rebin_axes_call_plain(*k2_args), 3)
    k1b = cuda_ms(lambda: grid_step_cuda(*k1_args), 20)
    k2b = cuda_ms(lambda: rebin_axes_call_cuda(*k2_args), 20)
    p1b = cuda_ms(lambda: grid_step_plain(*k1_args), 3)
    p2b = cuda_ms(lambda: rebin_axes_call_plain(*k2_args), 3)
    kernels["grid_step"].update(ms=min(k1a, k1b), plain_ms=min(p1, p1b))
    kernels["rebin_axes"].update(ms=min(k2a, k2b), plain_ms=min(p2, p2b))
    log(f"  times at 1664x1664 cap 14 (ms/call; {smi}): K1 {k1a:.4f} "
        f"{k1b:.4f} vs plain {p1:.3f} {p1b:.3f}; K2 {k2a:.4f} {k2b:.4f} "
        f"vs plain {p2:.3f} {p2b:.3f}")
    del slab0, slab11, k1_args, k2_args, eng

    # the cuda engine against the plain grid engine on a small run
    cfg_s = SimConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                      evac_capacity=2, rebin_every=4)
    st_s = init_particles(cfg_s, seed=SEED, device=dev)
    ra = get_engine("cuda", cfg_s, device=dev).run(st_s, nsteps=24)
    rb = get_engine("grid", cfg_s, device=dev).run(st_s, nsteps=24)
    e_pos = assert_close("engine cuda vs grid pos", ra.state.pos,
                         rb.state.pos, 0.0, 1e-5)
    if [int(v) for v in ra.monitors[:2]] != [int(v) for v in rb.monitors[:2]]:
        raise AssertionError(f"monitors differ: {ra.monitors} vs {rb.monitors}")
    log(f"  engine cuda vs grid, n=1000, 24 steps: positions max abs diff "
        f"{e_pos:.3e}; max_bin_count {int(ra.monitors.max_bin_count)}")
    torch.cuda.empty_cache()
    phase_line("1", "kernels agree with their plain twins", t0)

    # ---- phase 2: the CLI end to end -------------------------------------
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "ppsim_tpu_torch", "-n", "262144", "-s",
           str(SEED), "--steps", "200", "--engine", "cuda", "--check"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    for line in (proc.stdout + proc.stderr).strip().splitlines():
        log(f"  cli: {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"CLI exited {proc.returncode}")
    if "Simulation Time = " not in proc.stdout:
        raise RuntimeError("CLI printed no summary line")
    if "Correctness check: PASS" not in proc.stdout:
        raise RuntimeError("CLI checker did not PASS")
    phase_line("2", "CLI --check PASS", t0)

    # ---- phase 3: the main path at full width ----------------------------
    t0 = time.perf_counter()
    engine = get_engine("cuda", cfg, device=dev)
    for k in kernels.values():
        k["wrapper"].launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
    for k in kernels.values():
        k["launches"] = k["wrapper"].launches
    engine.check(result)
    slab = result.carry.slab
    pids = slab.pid[slab.pid >= 0].long()
    hist = torch.bincount(pids, minlength=N_MAIN)
    if pids.numel() != N_MAIN or hist.numel() != N_MAIN or int(hist.max()) != 1:
        raise AssertionError(
            f"pid census: {pids.numel()} live slots, max multiplicity "
            f"{int(hist.max())}, expected each of {N_MAIN} once")
    pos = result.state.pos
    if pos.shape != (N_MAIN, 2) or not bool(torch.isfinite(pos).all()):
        raise AssertionError("final positions not finite (N, 2)")
    # global coordinates are float32 sums xl + row*bs: allow a few ulps
    lo, hi = float(pos.min()), float(pos.max())
    if lo < -cfg.size * 2.0**-21 or hi > cfg.size * (1 + 2.0**-21):
        raise AssertionError(f"final positions [{lo}, {hi}] outside the "
                             f"box [0, {cfg.size}]")
    m = result.monitors
    k_step, k_rebin = kernels["grid_step"], kernels["rebin_axes"]
    warm = cfg.rebin_every  # timed_run's untimed warm-up period
    if (k_step["launches"] < STEPS_MAIN + warm
            or k_rebin["launches"] < STEPS_MAIN // CADENCE_MAIN + 1):
        raise AssertionError(f"launch counts {k_step['launches']}, "
                             f"{k_rebin['launches']} below the schedule")
    log(f"  n={N_MAIN} steps={STEPS_MAIN} rebin_every={CADENCE_MAIN} "
        f"capacity={engine.capacity}: {seconds:.4f} s = "
        f"{N_MAIN * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s "
        f"({smi})")
    log(f"  monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} "
        f"deferred {int(m.deferred)}")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"  launches: grid_step {k_step['launches']} (schedule {STEPS_MAIN} "
        f"+ {warm} warm-up), rebin_axes {k_rebin['launches']} (schedule "
        f"{STEPS_MAIN // CADENCE_MAIN} + 1 warm-up)")
    log(f"  every pid 0..{N_MAIN - 1} in exactly one slot")
    phase_line("3", "full-width main path clean", t0)

    out = [{k: v for k, v in rec.items() if k != "wrapper"}
           for rec in kernels.values()]
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
