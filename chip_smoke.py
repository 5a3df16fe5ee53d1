#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/Hopper port (``ppsim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its result and seconds on its own line:

0. the card (nvidia-smi name and power limit, torch's device name) and the
   kernel build from ``ppsim_tpu_torch/csrc`` (nvcc, sm_90a);
1. each kernel against its plain PyTorch twin on the card: K1 (fused step)
   allclose and K2 (fused rebin, one launch) bitwise at the main-path shape
   (n = 20,971,520: 1664 x 1664 bins, capacity 14), K2 also on a padded
   geometry, on a contention slab and on the slab with full bins and movers
   on its strips' halo bins (``testing.rebin_edge_slab``); kernel and plain
   times with CUDA events; and the ``cuda`` engine against the plain
   ``grid`` engine on a small run;
2. the CLI end to end: ``python -m ppsim_tpu_torch -n 262144 -s 42 --steps 200
   --engine cuda --check`` must print the summary line and a checker PASS;
3. the main path at full width: n = 20,971,520, 1000 steps, rebin cadence 11,
   engine ``cuda``, unsaved, through ``harness.timed_run``; the monitors must
   pass, every pid must sit in exactly one slot of the final slab, and both
   kernels must have launched; peak device memory; then K1 and K2 against
   their plain twins on the final slab (the late-run state) and their times
   there;
4. the 3D kernels against their plain twins on the card: K3 (fused 3D step)
   allclose, K4 (x + z pass, one launch) and K5 (y pass) bitwise,
   at the stretch geometry (n = 20,971,520, LJ: 140 x 152 x 256 bins,
   capacity 13) on the packed slab and after 8 steps, on the padded n =
   262,144 geometry with both laws, and K4/K5 on a 3D contention slab and on
   the 3D ``rebin_edge_slab``; times
   at the stretch shape; K1 with the LJ law on the 2D main-path slab; the
   ``cuda3d`` engine against the plain ``grid3d`` engine on a small run;
5. the 3D CLI end to end: ``python -m ppsim_tpu_torch -n 262144 --ndim 3
   --density 7e-6 --force-law lj --dt 1e-4 -s 42 --steps 200 --engine cuda3d
   --check`` must print the summary line and a checker PASS;
6. the stretch config at full width: n = 20,971,520, 3D LJ, 1000 steps,
   engine ``cuda3d``, unsaved, through ``harness.timed_run``; monitors, pid
   census, positions in the box, launch counts, peak device memory and a
   checker PASS on the final frame; K3, and K4 then K5, against their plain
   twins on the final slab and their times there; then a ``torch.profiler``
   window of two rebin periods;
7. the rest of the 2D family against its plain twins on the card: K6
   (force-only) allclose with both laws on the main-path slab after 11 steps
   and on the padded n = 262,144 geometry, K7 (dirs9 counts) and K8 (dirs9
   shuffle, a strip walk through shared memory) bitwise on those slabs, on
   the contention slab and on the slab with full bins and movers on K8's
   strip and segment edges (``testing.rebin_edge_slab``); kernel and plain
   times at the main-path shape; the ``cuda`` engine against the plain
   ``grid`` engine with ``grid_rebin_mode="dirs9"`` on a small run;
8. the CLI with dirs9: ``python -m ppsim_tpu_torch -n 262144 -s 42 --steps
   200 --engine cuda --grid-rebin-mode dirs9 --check`` must print the summary
   line and a checker PASS;
9. dirs9 at full width: phase 3's run with ``grid_rebin_mode="dirs9"``
   (monitors, pid census, positions in the box, K7/K8 launches), then the
   final state's accelerations through the engine's force-only API
   (``CudaGridEngine.accel_of``, K6) must obey Newton's third law (net force
   ~0), K6, K7 and K8 against their twins on that state and their times
   there; its seconds beside phase 3's, and ``profiling.phase_times`` of the
   ``cuda`` engine at the main-path config with each rebin mode;
10. the shard forms and the sharded engine ``sharded_grid`` on an in-process
   mesh of 4 shards (``engines/mesh.LocalMesh``): (a) K1, K2, K7 and K8 with
   a row offset and real ghost rows on the step-11 main-path slab cut into 4
   shards, against their twins (K1 allclose, the rebins bitwise) and against
   the rows of the single-device kernel's output on the whole slab (bitwise
   for all four), and K2, K7, K8 also on the shard-edge slab and its
   contention form (``testing.shard_edge_slab``); each shard form's time
   beside the single-device call on the same rows; (b) the main path on
   ``sharded_grid`` at full width (n = 20,971,520, 1000 steps, axes, cadence
   11): monitors, pid census, a checker PASS on the final frame, the final
   state bitwise equal to phase 3's, its seconds beside phase 3's, and a
   profiler window of two rebin periods; (c) the same with dirs9 for 200
   steps, against the single-device ``cuda`` engine's 200-step run;
11. the 3D shard forms and ``sharded_grid3d`` on 4 in-process shards: (a)
   K3, K4 and K5 with a y offset and real ghost slabs on the step-8 stretch
   slab cut into 4 shards of 35 slabs, against their twins (K3 allclose, the
   rebins bitwise, count planes included) and against the rows of the
   single-device kernels' output on the whole slab (bitwise for all three),
   K4 and K5 also on the 3D shard-edge slab and its contention form
   (``testing.shard_edge_slab3``); each shard form's time beside the
   single-device call on the same slabs; (b) the stretch config on
   ``sharded_grid3d`` at full width (n = 20,971,520, 3D LJ, 1000 steps,
   cadence 8): monitors, pid census, a checker PASS on the final frame, the
   final state bitwise equal to phase 6's, its seconds beside phase 6's, the
   shard forms' times on the final state, and a profiler window of two
   rebin periods;
12. the tile forms and the 2-D tile engine ``sharded_tile`` on in-process
   meshes (``LocalMesh((Pr, Pc))``): (a) K1 and K2 with row and column
   offsets and real ghost rows, ghost columns and corners on the step-11
   main-path slab, its columns padded to the tile geometry and cut into
   2 x 2 tiles and into 1 x 4, against their twins (K1 allclose, K2
   bitwise) and against the bins of the single-device kernels' output on the
   whole padded slab (bitwise for both); each tile form's time beside the
   single-device call on the same bins and a quarter of the whole-slab
   call; (b) the main path on ``sharded_tile`` with a 2 x 2 mesh at full
   width (n = 20,971,520, 1000 steps, axes, cadence 11): monitors, pid
   census, a checker PASS on the final frame, the final state bitwise equal
   to phase 3's, its seconds beside phase 3's, and a profiler window of two
   rebin periods; (c) dirs9 on the tile route (the torch ops on each tile's
   ghost ring, as the JAX engine runs it) for 200 steps, against phase
   10c's single-device ``cuda`` dirs9 run, with its slowest device ops;
13. the particle-list engines (plain PyTorch: in the JAX package they reach
   no Pallas kernel, so they launch no kernel of the port): (a) ``oracle``
   against ``binned`` at n = 16,384, 100 steps, frames bitwise equal (the
   JAX package's contract), and the float64 ``oracle`` (float32 beside it)
   on 1,024 particles for 10 steps against the native float64
   ``ppsim_run_oracle``; (b) ``binned`` at n = 20,971,520 for 200 steps
   through ``harness.timed_run``: seconds and particle-steps/s beside phase
   3's, monitors, the pid permutation, peak device memory, a checker PASS
   on the final frame and a profiler window of 3 steps; (c) ``sharded`` on
   4 in-process strips from the same state, final state bitwise equal to
   (b)'s, nothing dropped; (d) ``binned3d`` on the stretch config for 10
   steps: monitors, pid permutation, checker PASS; (e) the CLI
   ``--engine binned -n 262144 --steps 200 --check`` in float32 and with
   ``--dtype float64``, the two processes started together; (f)
   ``binned3d`` against the 3D ``oracle`` at n = 800 for 100 steps with
   both laws, frames within 1e-6 and pairs in range; (g) ``sharded`` on 4
   strips bitwise equal to ``binned`` under LJ, n = 262,144, 300 steps;
14. the 3D repulsive config at full width (n = 20,971,520, ``--ndim 3
   --density 7e-6``, dt 5e-4, fast init, 1000 steps, unsaved, ``cuda3d``,
   through ``harness.timed_run``; 205 x 208 x 128 bins, cadence 2) in three
   arms from one initial state: (a) no init spill and no repack, the whole
   run at the packing capacity; (b) no init spill with the capacity-phase
   repack (a prologue at the packing capacity, then attempts to repack down
   to the run capacity 11); (c) the defaults (the init spill keeps capacity
   11). Each arm: seconds, particle-steps/s, packing and final capacity,
   repack attempts and switch, monitors, pid census, peak device memory,
   launches, a checker PASS on the final frame and K3's time on its final
   slab. (b)'s final state bitwise equal to (a)'s if it never committed
   (else its largest difference); K3, K4 and K5 against their plain twins
   on (b)'s final slab and their times there.

The line before the last is a JSON object with each kernel's launches in its
full-width run (phase 3 for K1 and K2, phase 6 for K3-K5, phase 9 for K6-K8,
phase 10 for the 2D shard forms, phase 11 for the 3D ones, phase 12b for the
tile forms, phase 14's arm (b) for the ``*_repulsive`` records, which add
``ms_by_capacity``, K3 on the final slabs of arms (a) and (c)),
its largest
difference from the plain twin, its time beside the plain twin's and its
bound (the larger of its bytes over 3.35 TB/s and its operations over 67
TFLOP/s float32, counted from this run's inputs), and ``ms_late``, its
time on the final state of its full-width run beside ``ms`` on the early
slab; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import itertools
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
# K1 parity: owner-computes sums in the plain twin's order with the twin's
# rounding, but the repulsive rsqrtf may differ from torch.rsqrt by an ulp;
# accelerations reach ~1e4 in close encounters, so velocities carry ~1e-7
# relative error.
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# K3 parity: the same summation order and rounding as its twin; the
# repulsive rsqrtf differs from torch.rsqrt by an ulp, which the force sums
# carry into velocities at ~1e-7 relative.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# K6 parity: K1's pair loop, but its outputs are the pair sums themselves,
# where close pairs' terms cancel: 1e-5 relative, and 1e-6 of the largest
# |a| absolute (an ulp of rsqrtf moves the last bit of a term).
K6_RTOL, K6_ATOL_OF_MAX = 1e-5, 1e-6
# Newton's third law on the full-width final state: each pair is evaluated
# from both sides in bin-local frames, whose rounding differs by ~1e-6
# relative per pair; the net force must be below 1e-5 of the summed |a|.
NEWTON3_RTOL = 1e-5
# The stretch config (BASELINE.json configs[4]; README, bench/r5_*.sh).
STRETCH = dict(num_parts=20_971_520, ndim=3, density=7e-6, force_law="lj",
               dt=1e-4)
STRETCH_GEOM = (140, 152, 256, 13, 8)  # ys, xs, zs, capacity, cadence
N_PAD3 = 262_144  # 41^3 bins padded to 41 x 48 x 128, capacity 10
# Phase 10: shards of the in-process mesh, and the depth of the dirs9 run.
SHARDS = 4
STEPS_DIRS9_SHARDED = 200
# Phase 12: the tile meshes (the near-square one of 4, and columns only).
TILE_MESHES = ((2, 2), (1, 4))
# Phase 13: the particle-list engines. 13a: oracle == binned bitwise at
# n = 16,384 (the JAX package's own contract, at 10x its test's n), and the
# oracle against the native float64 one (the bounds of the JAX package's
# tests/test_native.py: f64 1e-9, f32 1e-4); 13b-c: the main path's n for
# 200 steps; 13d: the stretch config on binned3d for 10 steps (a step costs
# ~0.6 s: 27 gathers of (n, 8) slots), so that phase 13 stays near 90 s.
N_ORACLE, STEPS_ORACLE = 16_384, 100
N_ORACLE64, STEPS_ORACLE64 = 1024, 10
ORACLE64_ATOL, ORACLE32_ATOL = 1e-9, 1e-4
STEPS_PARTICLE = 200
PROFILE_PARTICLE = 3
STEPS_BINNED3D = 10
# 13f: binned3d against the 3D oracle at the JAX package's 3D test config
# (tests/test_3d.py), 100 steps, so that ~100 (repulsive) and ~340 (LJ)
# pairs are in range by the end; its CPU bound. 13g: sharded on 4 strips
# against binned under LJ, bitwise, at n = 262,144 for 300 steps (the
# lattice's first pairs come in range after ~100).
CFG_BINNED3D_ORACLE = dict(num_parts=800, ndim=3, density=7e-6, bin_capacity=8)
STEPS_BINNED3D_ORACLE, BINNED3D_ATOL = 100, 1e-6
N_SHARDED_LJ, STEPS_SHARDED_LJ = 262_144, 300
# Phase 14: the 3D repulsive config at full width (bench/r3_queue.sh:47,
# stage 2b, without its hand capacity), three arms from one initial state:
# (a) no init spill, no repack: the whole run at the packing capacity;
# (b) no init spill, the capacity-phase repack; (c) the defaults (spill).
REPULSIVE3 = dict(num_parts=20_971_520, ndim=3, density=7e-6, dt=5e-4)
REPULSIVE3_GEOM = (205, 208, 128, 11, 2)  # ys, xs, zs, capacity, cadence
REPACK_ARMS = (
    ("a", "no spill, no repack", dict(grid3_spill=False, grid3_repack=False)),
    ("b", "no spill, repack", dict(grid3_spill=False, grid3_repack=True)),
    ("c", "defaults (spill)", {}),
)
# Peak rates of one NVIDIA H100 SXM at 700 W (HBM3 bandwidth, dense FP32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


def late_ms(fn) -> float:
    """A step kernel's ms per call on a late-run slab: min of two runs of 10
    calls."""
    return min(cuda_ms(fn, 10), cuda_ms(fn, 10))


def bound_of(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time for the work on one H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def candidate_pairs(pid) -> int:
    """Unordered pairs of live particles in neighbouring bins (3x3 in 2D,
    3x3x3 in 3D, the own bin included): the distance tests a step needs
    at least, counted from this slab."""
    import torch

    n = (pid >= 0).sum(dim=0, dtype=torch.int64)
    padded = torch.nn.functional.pad(n, (1, 1) * n.dim())
    near = torch.zeros_like(n)
    for off in itertools.product(range(3), repeat=n.dim()):
        near += padded[tuple(slice(o, o + m) for o, m in zip(off, n.shape))]
    return int(((n * near).sum() - n.sum()) // 2)


def check_final(slab, pos, n: int, ndim: int, size: float) -> None:
    """Every pid 0..n-1 in exactly one slot of the final slab, and the final
    positions finite, (n, ndim) and inside the box (global coordinates are
    float32 sums xl + row * bs: a few ulps are allowed)."""
    import torch

    pids = slab.pid[slab.pid >= 0].long()
    hist = torch.bincount(pids, minlength=n)
    if pids.numel() != n or hist.numel() != n or int(hist.max()) != 1:
        raise AssertionError(
            f"pid census: {pids.numel()} live slots, max multiplicity "
            f"{int(hist.max())}, expected each of {n} once")
    if pos.shape != (n, ndim) or not bool(torch.isfinite(pos).all()):
        raise AssertionError(f"final positions not finite ({n}, {ndim})")
    lo, hi = float(pos.min()), float(pos.max())
    if lo < -size * 2.0**-21 or hi > size * (1 + 2.0**-21):
        raise AssertionError(f"final positions [{lo}, {hi}] outside the "
                             f"box [0, {size}]")


def final_frame_check(label: str, pos, cfg) -> None:
    """The absmin/absavg checker on one (final) frame; raises on FAIL."""
    from ppsim_tpu_torch.checker import ABSAVG_BAND, ABSMIN_BAND, frame_distance_stats

    tc = time.perf_counter()
    dmin, dsum, dcount = frame_distance_stats(pos.cpu().numpy(), cfg.cutoff)
    absavg = dsum / dcount if dcount else float("inf")
    cut = cfg.cutoff
    verdict = dmin > ABSMIN_BAND * cut and absavg > ABSAVG_BAND * cut
    log(f"  checker on the final frame of {label} ({time.perf_counter() - tc:.1f} s): "
        f"{'PASS' if verdict else 'FAIL'} absmin {dmin:.6g} ({dmin / cut:.2f} "
        f"cutoff), absavg {absavg:.6g} ({absavg / cut:.2f} cutoff), {dcount} "
        f"interacting pairs")
    if not verdict:
        raise AssertionError(f"checker failed on the final frame of {label}")


def run_cli(label: str, args) -> None:
    """``python -m ppsim_tpu_torch *args`` must exit 0 and print the summary
    line and a checker PASS."""
    run_clis([(label, args)])


def run_clis(runs) -> None:
    """:func:`run_cli` for each ``(label, args)`` of ``runs``, the processes
    started together (they share the card: their summary times are not
    measurements)."""
    procs = [(label, subprocess.Popen([sys.executable, "-m", "ppsim_tpu_torch", *args],
                                      cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
             for label, args in runs]
    outs = []
    try:
        for label, proc in procs:
            out, err = proc.communicate(timeout=600)
            outs.append((label, proc.returncode, out, err))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, _, out, err in outs:
        for line in (out + err).strip().splitlines():
            log(f"  cli ({label}): {line}")
    for label, rc, out, _ in outs:
        if rc != 0:
            raise RuntimeError(f"{label} exited {rc}")
        if "Simulation Time = " not in out:
            raise RuntimeError(f"{label} printed no summary line")
        if "Correctness check: PASS" not in out:
            raise RuntimeError(f"{label} checker did not PASS")


def k1_compare(name, slab, geom, cfg, law="repulsive", law_params=()) -> float:
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain

    args = (slab.xl, slab.yl, slab.vx, slab.vy, geom, cfg.cutoff, cfg.min_r,
            cfg.mass, cfg.dt, cfg.size, law, law_params)
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


def k3_compare(name, slab, geom, cfg) -> float:
    """K3 against its plain twin; returns the max abs difference."""
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain

    args = (*slab[:6], geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt,
            cfg.size, cfg.force_law, cfg.law_params)
    got = grid3_step_cuda(*args)
    want = grid3_step_plain(*args)
    errs = [assert_close(f"K3 {name} {p}", g, w, K3_RTOL, K3_ATOL)
            for p, g, w in zip(("xl", "yl", "zl", "vx", "vy", "vz", "speed2"),
                               got, want)]
    log(f"  K3 {name} ({cfg.force_law}): allclose (rtol {K3_RTOL:g}, atol "
        f"{K3_ATOL:g}); max abs diff " + " ".join(f"{e:.3e}" for e in errs))
    return max(errs)


def k45_compare(name, slab, geom, evac) -> None:
    """K4 then K5 against their plain twins, bitwise on all planes."""
    from ppsim_tpu_torch.ops.cuda_rebin3 import (
        ALIVE_PRE, FAR_PRE, rebin3_inplane_cuda, rebin3_inplane_plain,
        rebin3_ypass_cuda, rebin3_ypass_plain,
    )
    from ppsim_tpu_torch.ops.grid3d_ops import rebin3_monitors

    mid, cnt = rebin3_inplane_cuda(slab, geom, evac)
    wmid, wcnt = rebin3_inplane_plain(slab, geom, evac)
    for f, g, w in zip(mid._fields, mid, wmid):
        assert_equal(f"K4 {name} {f}", g, w)
    assert_equal(f"K4 {name} count planes", cnt, wcnt)
    del wmid
    out, post = rebin3_ypass_cuda(mid, cnt, geom, evac)
    wout, wpost = rebin3_ypass_plain(mid, cnt, geom, evac)
    for f, g, w in zip(out._fields, out, wout):
        assert_equal(f"K5 {name} {f}", g, w)
    assert_equal(f"K5 {name} post planes", post, wpost)
    mon = [int(v) for v in rebin3_monitors(cnt[FAR_PRE], cnt[ALIVE_PRE], post)]
    moved = int((out.pid != slab.pid).sum())
    log(f"  K4+K5 {name}: bitwise equal on 7 planes + 5 count planes + 2 "
        f"post planes; slots changed {moved}; monitors (max_occ, dropped, "
        f"deferred) {mon}")


def phase_3d(kernels, state2d, cfg2d, smi: str):
    """Phases 4-6: the 3D kernels against their twins, the 3D CLI, and the
    stretch config at full width. Fills the K3-K5 records of ``kernels``;
    returns the stretch config's initial state and phase 6's (final
    ParticleState, seconds)."""
    import torch

    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin3 import (
        rebin3_inplane_cuda, rebin3_inplane_plain, rebin3_plan, rebin3_ypass_cuda,
        rebin3_ypass_plain,
    )
    from ppsim_tpu_torch.profiling import profile_steps
    from ppsim_tpu_torch.testing import (
        REBIN_EDGE_GEOMETRY3, STRESS_GEOMETRY3, rebin_edge_slab, stress_slab3,
    )

    dev = torch.device("cuda", 0)
    k3, k4, k5 = (kernels[k] for k in ("grid3_step", "rebin3_inplane",
                                       "rebin3_ypass"))

    # ---- phase 4: the 3D kernels against their plain twins ---------------
    t0 = time.perf_counter()
    cfg3 = SimConfig(**STRETCH)
    eng3 = get_engine("cuda3d", cfg3, device=dev)
    g3, evac = eng3.geom, cfg3.evac_capacity
    log(f"  stretch geometry: {g3.ys}x{g3.xs}x{g3.zs} bins (array "
        f"{g3.ys_pad}x{g3.xs_pad}x{g3.zs_pad}), capacity {g3.capacity}, "
        f"cadence {eng3.rebin_every}, bin sides y {g3.bsy:.6g} x "
        f"{g3.bsx:.6g} z {g3.bsz:.6g}")
    if (g3.ys, g3.xs, g3.zs, g3.capacity, eng3.rebin_every) != STRETCH_GEOM:
        raise AssertionError(f"unexpected stretch geometry {g3}")
    ti = time.perf_counter()
    state3 = init_particles(cfg3, seed=SEED, method="fast", device=dev)
    torch.cuda.synchronize()
    log(f"init_particles fast 3D (n={cfg3.num_parts}, seed={SEED}): "
        f"{time.perf_counter() - ti:.2f} s")
    carry = eng3.init_carry(state3)
    err3 = k3_compare("stretch packed slab", carry.slab, g3, cfg3)
    for _ in range(eng3.rebin_every):
        carry = eng3.step_plain(carry)
    slab8 = carry.slab
    del carry
    err3 = max(err3, k3_compare(f"stretch after {eng3.rebin_every} steps",
                                slab8, g3, cfg3))
    k45_compare(f"stretch after {eng3.rebin_every} steps", slab8, g3, evac)

    for law_kw in ({}, dict(force_law="lj", dt=1e-4)):
        cfg_p = SimConfig(num_parts=N_PAD3, ndim=3, density=7e-6, **law_kw)
        eng_p = get_engine("cuda3d", cfg_p, device=dev)
        gp = eng_p.geom
        log(f"  padded geometry ({cfg_p.force_law}): {gp.ys}x{gp.xs}x{gp.zs} "
            f"in {gp.ys_pad}x{gp.xs_pad}x{gp.zs_pad}, capacity {gp.capacity}")
        carry = eng_p.init_carry(init_particles(cfg_p, seed=SEED,
                                                method="fast", device=dev))
        for _ in range(eng_p.rebin_every):
            carry = eng_p.step_plain(carry)
        err3 = max(err3, k3_compare(f"padded {gp.shape}", carry.slab, gp, cfg_p))
        k45_compare(f"padded ({cfg_p.force_law})", carry.slab, gp,
                    cfg_p.evac_capacity)
    gs = STRESS_GEOMETRY3
    k45_compare("contention slab", stress_slab3(gs, 0, 2, dev), gs, 2)
    ge = REBIN_EDGE_GEOMETRY3
    k45_compare("strip-edge slab", rebin_edge_slab(ge, rebin3_plan(ge.shape), 0, dev),
                ge, 2)
    k3["max_abs_err"] = err3
    k4["max_abs_err"] = k5["max_abs_err"] = 0.0

    # K1 with the LJ law on the 2D main-path slab
    eng2 = get_engine("cuda", cfg2d, device=dev)
    carry = eng2.init_carry(state2d)
    for _ in range(CADENCE_MAIN):
        carry = eng2.step_plain(carry)
    lj2 = cfg2d.with_(force_law="lj", dt=1e-4)
    e1 = k1_compare(f"LJ, 2D main-path slab after {CADENCE_MAIN} steps",
                    carry.slab, eng2.geom, lj2, "lj", lj2.law_params)
    kernels["grid_step"]["max_abs_err"] = max(kernels["grid_step"]["max_abs_err"], e1)
    del eng2, carry

    # the cuda3d engine against the plain grid3d engine on a small run
    for law_kw in ({}, dict(force_law="lj", dt=1e-4)):
        cfg_s = SimConfig(num_parts=500, ndim=3, density=7e-6, grid3_capacity=8,
                          evac_capacity=2, rebin3_every=4, **law_kw)
        st_s = init_particles(cfg_s, seed=SEED, method="fast", device=dev)
        ra = get_engine("cuda3d", cfg_s, device=dev).run(st_s, nsteps=24)
        rb = get_engine("grid3d", cfg_s, device=dev).run(st_s, nsteps=24)
        e_pos = assert_close(f"engine cuda3d vs grid3d pos ({cfg_s.force_law})",
                             ra.state.pos, rb.state.pos, 0.0, 1e-5)
        if [int(v) for v in ra.monitors[:2]] != [int(v) for v in rb.monitors[:2]]:
            raise AssertionError(f"monitors differ: {ra.monitors} vs {rb.monitors}")
        log(f"  engine cuda3d vs grid3d ({cfg_s.force_law}), n=500, 24 steps: "
            f"positions max abs diff {e_pos:.3e}; max_bin_count "
            f"{int(ra.monitors.max_bin_count)}")

    # times at the stretch shape: plain, kernel, kernel, plain
    a3 = (*slab8[:6], g3, cfg3.cutoff, cfg3.min_r, cfg3.mass, cfg3.dt,
          cfg3.size, cfg3.force_law, cfg3.law_params)
    mid, cnt = rebin3_inplane_cuda(slab8, g3, evac)
    plain_fns = {"k3": lambda: grid3_step_plain(*a3),
                 "k4": lambda: rebin3_inplane_plain(slab8, g3, evac),
                 "k5": lambda: rebin3_ypass_plain(mid, cnt, g3, evac)}
    kern_fns = {"k3": lambda: grid3_step_cuda(*a3),
                "k4": lambda: rebin3_inplane_cuda(slab8, g3, evac),
                "k5": lambda: rebin3_ypass_cuda(mid, cnt, g3, evac)}
    plain = {k: [cuda_ms(fn, 1)] for k, fn in plain_fns.items()}
    kern = {k: [cuda_ms(fn, 10)] for k, fn in kern_fns.items()}
    for k, fn in kern_fns.items():
        kern[k].append(cuda_ms(fn, 10))
    for k, fn in plain_fns.items():
        plain[k].append(cuda_ms(fn, 1))
    # bounds on this slab: K3 reads 6 planes and writes 6 + the speed plane
    # and makes at least 8 flops (3 sub, 3 mul, 2 add) per candidate pair;
    # K4 reads 7 planes and writes 7 + 5 count planes; K5 reads 7 planes +
    # 2 count planes and writes 7 + 2 post planes
    plane_b = 4 * slab8.xl.numel()
    bin_b = plane_b // g3.capacity
    pairs3 = candidate_pairs(slab8.pid)
    for rec, key, nbytes, flops in (
            (k3, "k3", 12 * plane_b + bin_b, 8 * pairs3),
            (k4, "k4", 14 * plane_b + 5 * bin_b, 0),
            (k5, "k5", 14 * plane_b + 4 * bin_b, 0)):
        bound, by = bound_of(nbytes, flops)
        rec.update(ms=min(kern[key]), plain_ms=min(plain[key]),
                   bound_ms=bound, bound_by=by)
    log(f"  times at {g3.ys}x{g3.xs}x{g3.zs} cap {g3.capacity} (ms/call; "
        f"{smi}): " + "; ".join(f"{k} {' '.join(f'{t:.4f}' for t in v)}"
                                 for k, v in kern.items())
        + "; plain " + "; ".join(f"{k} {' '.join(f'{t:.3f}' for t in v)}"
                                 for k, v in plain.items()))
    log(f"  bounds: K3 {k3['bound_ms']:.4f} ms ({k3['bound_by']}; {pairs3} "
        f"candidate pairs), K4 {k4['bound_ms']:.4f} ms, K5 "
        f"{k5['bound_ms']:.4f} ms (bytes)")
    del slab8, mid, cnt, a3, eng3
    torch.cuda.empty_cache()
    phase_line("4", "3D kernels agree with their plain twins", t0)

    # ---- phase 5: the 3D CLI end to end ----------------------------------
    t0 = time.perf_counter()
    run_cli("3D CLI", ["-n", str(N_PAD3), "--ndim", "3", "--density", "7e-6",
                       "--force-law", "lj", "--dt", "1e-4", "-s", str(SEED),
                       "--steps", "200", "--engine", "cuda3d", "--check"])
    phase_line("5", "3D CLI --check PASS", t0)

    # ---- phase 6: the stretch config at full width ------------------------
    t0 = time.perf_counter()
    n3 = cfg3.num_parts
    engine = get_engine("cuda3d", cfg3, device=dev)
    for rec in (k3, k4, k5):
        rec["wrapper"].launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    result, seconds = timed_run(engine, state3, STEPS_MAIN, 0)
    for rec in (k3, k4, k5):
        rec["launches"] = rec["wrapper"].launches
    peak = torch.cuda.max_memory_allocated(dev)
    engine.check(result)
    pos = result.state.pos
    check_final(result.carry.slab, pos, n3, 3, cfg3.size)
    cadence = engine.rebin_every
    if (k3["launches"] < STEPS_MAIN + cadence
            or min(k4["launches"], k5["launches"]) < STEPS_MAIN // cadence + 1):
        raise AssertionError(f"launch counts {k3['launches']}, "
                             f"{k4['launches']}, {k5['launches']} below the "
                             "schedule")
    final_frame_check("the stretch config", pos, cfg3)
    m = result.monitors
    log(f"  n={n3} 3D LJ steps={STEPS_MAIN} rebin_every={cadence} "
        f"capacity={engine.capacity}: {seconds:.4f} s = "
        f"{n3 * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s ({smi})")
    log(f"  monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} "
        f"deferred {int(m.deferred)}")
    log(f"  peak device memory: {peak} bytes ({smi})")
    log(f"  launches: grid3_step {k3['launches']} (schedule {STEPS_MAIN} + "
        f"{cadence} warm-up), rebin3_inplane {k4['launches']}, rebin3_ypass "
        f"{k5['launches']} (schedule {STEPS_MAIN // cadence} + 1 warm-up)")
    log(f"  every pid 0..{n3 - 1} in exactly one slot")
    # K3 on the final slab: the late-run state, LJ clusters included
    slab_f = result.carry.slab
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_compare(
        f"final slab ({STEPS_MAIN} steps)", slab_f, g3, cfg3))
    a3f = (*slab_f[:6], g3, cfg3.cutoff, cfg3.min_r, cfg3.mass, cfg3.dt,
           cfg3.size, cfg3.force_law, cfg3.law_params)
    k3["ms_late"] = late_ms(lambda: grid3_step_cuda(*a3f))
    log(f"  K3 on the final slab: {k3['ms_late']:.4f} ms/call (step-8 slab "
        f"{k3['ms']:.4f}; bound there {k3['bound_ms']:.4f}; {smi})")
    k45_compare(f"final slab ({STEPS_MAIN} steps)", slab_f, g3, cfg3.evac_capacity)
    mid, cnt = rebin3_inplane_cuda(slab_f, g3, cfg3.evac_capacity)
    k4["ms_late"] = late_ms(lambda: rebin3_inplane_cuda(slab_f, g3, cfg3.evac_capacity))
    k5["ms_late"] = late_ms(lambda: rebin3_ypass_cuda(mid, cnt, g3, cfg3.evac_capacity))
    log(f"  K4, K5 on the final slab: {k4['ms_late']:.4f}, {k5['ms_late']:.4f} "
        f"ms/call (step-8 slab {k4['ms']:.4f}, {k5['ms']:.4f}; bounds there "
        f"{k4['bound_ms']:.4f}, {k5['bound_ms']:.4f}; {smi})")
    del slab_f, a3f, mid, cnt
    torch.cuda.empty_cache()
    _, win = profile_steps(engine, result.carry, STEPS_MAIN + 1, 2 * cadence)
    log(f"  torch.profiler, steps {win.steps.start}-{win.steps.stop - 1}:")
    for line in win.table().splitlines():
        log(f"    {line}")
    phase_line("6", "stretch config at full width clean", t0)
    return state3, (result.state, seconds)


def k6_compare(name, slab, geom, cfg) -> float:
    """K6 against its plain twin; returns the max abs difference."""
    import torch

    from ppsim_tpu_torch.ops.cuda_grid import grid_force_cuda, grid_force_plain

    args = (slab.xl, slab.yl, geom, cfg.cutoff, cfg.min_r, cfg.mass,
            cfg.force_law, cfg.law_params)
    got = grid_force_cuda(*args)
    want = grid_force_plain(*args)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    atol = K6_ATOL_OF_MAX * scale
    errs = [assert_close(f"K6 {name} {p}", g, w, K6_RTOL, atol)
            for p, g, w in zip(("ax", "ay"), got, want)]
    log(f"  K6 {name} ({cfg.force_law}): allclose (rtol {K6_RTOL:g}, atol "
        f"{K6_ATOL_OF_MAX:g} x max|a| = {atol:.3e}); max abs diff ax "
        f"{errs[0]:.3e} ay {errs[1]:.3e}; max|a| {scale:.6g}")
    return max(errs)


def k78_compare(name, slab, geom, evac, want_dropped=None) -> None:
    """K7 then K8 against their plain twins, bitwise on all planes."""
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_counts_cuda, rebin_counts_plain, rebin_shuffle_cuda,
        rebin_shuffle_plain,
    )
    from ppsim_tpu_torch.ops.grid_ops import monitors_of_counts

    counts = rebin_counts_cuda(slab, geom)
    assert_equal(f"K7 {name} count planes", counts, rebin_counts_plain(slab, geom))
    out, cnt = rebin_shuffle_cuda(slab, counts, geom, evac)
    want, wcnt = rebin_shuffle_plain(slab, counts, geom, evac)
    for f, g, w in zip(out._fields, out, want):
        assert_equal(f"K8 {name} {f}", g, w)
    assert_equal(f"K8 {name} monitor planes", cnt, wcnt)
    mon = [int(v) for v in monitors_of_counts(cnt)]
    if want_dropped is not None and mon[1] != want_dropped:
        raise AssertionError(f"K8 {name}: dropped {mon[1]}, expected {want_dropped}")
    moved = int((out.pid != slab.pid).sum())
    log(f"  K7+K8 {name}: bitwise equal on 9 count planes, 5 planes + 4 "
        f"monitor planes; slots changed {moved}; monitors (max_occ, dropped, "
        f"deferred) {mon}")


def phase_2d_rest(kernels, state, cfg, axes_seconds: float, smi: str) -> None:
    """Phases 7-9: the rest of the 2D kernel family (K6 force-only, K7 + K8
    dirs9 rebin) against its twins, the dirs9 CLI, and dirs9 at full width.
    Fills the K6-K8 records of ``kernels``."""
    import torch

    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.ops.cuda_grid import grid_force_cuda, grid_force_plain
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_counts_cuda, rebin_counts_plain, rebin_shuffle_cuda,
        rebin_shuffle_plain, shuffle_plan,
    )
    from ppsim_tpu_torch.profiling import phase_times
    from ppsim_tpu_torch.testing import (
        REBIN_EDGE_GEOMETRY, STRESS_GEOMETRY, rebin_edge_slab, stress_slab,
    )

    dev = torch.device("cuda", 0)
    k6, k7, k8 = (kernels[k] for k in ("grid_force", "rebin_counts",
                                       "rebin_shuffle"))
    cfg9 = cfg.with_(grid_rebin_mode="dirs9")

    # ---- phase 7: K6-K8 against their plain twins -------------------------
    t0 = time.perf_counter()
    eng = get_engine("cuda", cfg9, device=dev)
    geom, evac = eng.geom, cfg.evac_capacity
    carry = eng.init_carry(state)
    for _ in range(CADENCE_MAIN):
        carry = eng.step_plain(carry)
    slab11 = carry.slab
    del carry
    lj2 = cfg.with_(force_law="lj", dt=1e-4)
    err6 = max(k6_compare(f"main-path slab after {CADENCE_MAIN} steps", slab11,
                          geom, c) for c in (cfg, lj2))
    k78_compare(f"main-path slab after {CADENCE_MAIN} steps", slab11, geom, evac)
    for law_kw in ({}, dict(force_law="lj", dt=1e-4)):
        cfg_p = SimConfig(num_parts=262_144, **law_kw)
        eng_p = get_engine("cuda", cfg_p.with_(grid_rebin_mode="dirs9"), device=dev)
        gp = eng_p.geom
        carry = eng_p.init_carry(init_particles(cfg_p, seed=SEED, device=dev))
        for _ in range(cfg_p.rebin_every):
            carry = eng_p.step_plain(carry)
        err6 = max(err6, k6_compare(f"padded {gp.shape}", carry.slab, gp, cfg_p))
        k78_compare(f"padded ({cfg_p.force_law})", carry.slab, gp,
                    cfg_p.evac_capacity)
    gs = STRESS_GEOMETRY
    k78_compare("contention slab", stress_slab(gs, 0, 2, dev), gs, 2,
                want_dropped=2)
    ge = REBIN_EDGE_GEOMETRY
    k78_compare("strip-edge slab",
                rebin_edge_slab(ge, shuffle_plan(ge.shape), 0, dev), ge, 2)
    k6["max_abs_err"] = err6
    k7["max_abs_err"] = k8["max_abs_err"] = 0.0

    # the cuda engine against the plain grid engine with dirs9, small run
    cfg_s = SimConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=6,
                      evac_capacity=2, rebin_every=4, grid_rebin_mode="dirs9")
    st_s = init_particles(cfg_s, seed=SEED, device=dev)
    ra = get_engine("cuda", cfg_s, device=dev).run(st_s, nsteps=24)
    rb = get_engine("grid", cfg_s, device=dev).run(st_s, nsteps=24)
    e_pos = assert_close("engine cuda vs grid pos (dirs9)", ra.state.pos,
                         rb.state.pos, 0.0, 1e-5)
    if [int(v) for v in ra.monitors[:2]] != [int(v) for v in rb.monitors[:2]]:
        raise AssertionError(f"monitors differ: {ra.monitors} vs {rb.monitors}")
    log(f"  engine cuda vs grid (dirs9), n=1000, 24 steps: positions max abs "
        f"diff {e_pos:.3e}; max_bin_count {int(ra.monitors.max_bin_count)}")

    # times at the main-path shape: plain, kernel, kernel, plain
    counts = rebin_counts_cuda(slab11, geom)
    fa = (slab11.xl, slab11.yl, geom, cfg.cutoff, cfg.min_r, cfg.mass)
    plain_fns = {"k6": lambda: grid_force_plain(*fa),
                 "k7": lambda: rebin_counts_plain(slab11, geom),
                 "k8": lambda: rebin_shuffle_plain(slab11, counts, geom, evac)}
    kern_fns = {"k6": lambda: grid_force_cuda(*fa),
                "k7": lambda: rebin_counts_cuda(slab11, geom),
                "k8": lambda: rebin_shuffle_cuda(slab11, counts, geom, evac)}
    plain = {k: [cuda_ms(fn, 2)] for k, fn in plain_fns.items()}
    kern = {k: [cuda_ms(fn, 20)] for k, fn in kern_fns.items()}
    for k, fn in kern_fns.items():
        kern[k].append(cuda_ms(fn, 20))
    for k, fn in plain_fns.items():
        plain[k].append(cuda_ms(fn, 2))
    # bounds on this slab: K6 reads 2 planes and writes 2, and makes at least
    # 5 flops (2 sub, 2 mul, 1 add) per candidate pair; K7 reads 3 planes and
    # writes 9 count planes; K8 reads 5 planes + 9 count planes and writes 5
    # planes + 4 monitor planes
    plane_b = 4 * slab11.xl.numel()
    bin_b = plane_b // geom.capacity
    pairs2 = candidate_pairs(slab11.pid)
    for rec, key, nbytes, flops in (
            (k6, "k6", 4 * plane_b, 5 * pairs2),
            (k7, "k7", 3 * plane_b + 9 * bin_b, 0),
            (k8, "k8", 10 * plane_b + 13 * bin_b, 0)):
        bound, by = bound_of(nbytes, flops)
        rec.update(ms=min(kern[key]), plain_ms=min(plain[key]),
                   bound_ms=bound, bound_by=by)
    log(f"  times at {geom.rows}x{geom.cols} cap {geom.capacity} (ms/call; "
        f"{smi}): " + "; ".join(f"{k} {' '.join(f'{t:.4f}' for t in v)}"
                                 for k, v in kern.items())
        + "; plain " + "; ".join(f"{k} {' '.join(f'{t:.3f}' for t in v)}"
                                 for k, v in plain.items()))
    log(f"  bounds: K6 {k6['bound_ms']:.4f} ms ({k6['bound_by']}; {pairs2} "
        f"candidate pairs), K7 {k7['bound_ms']:.4f} ms, K8 "
        f"{k8['bound_ms']:.4f} ms (bytes)")
    del slab11, counts, fa, eng
    torch.cuda.empty_cache()
    phase_line("7", "K6-K8 agree with their plain twins", t0)

    # ---- phase 8: the CLI with dirs9 --------------------------------------
    t0 = time.perf_counter()
    run_cli("dirs9 CLI", ["-n", "262144", "-s", str(SEED), "--steps", "200",
                          "--engine", "cuda", "--grid-rebin-mode", "dirs9",
                          "--check"])
    phase_line("8", "dirs9 CLI --check PASS", t0)

    # ---- phase 9: dirs9 at full width -------------------------------------
    t0 = time.perf_counter()
    engine = get_engine("cuda", cfg9, device=dev)
    path9 = [kernels[k] for k in ("grid_step", "grid_force", "rebin_counts",
                                  "rebin_shuffle")]
    for k in path9:
        k["wrapper"].launches = 0
    result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
    engine.check(result)
    slab = result.carry.slab
    ax, ay = engine.accel_of(slab.xl, slab.yl)
    torch.cuda.synchronize()
    launches9 = [k["wrapper"].launches for k in path9]
    for k in path9[1:]:
        k["launches"] = k["wrapper"].launches
    check_final(slab, result.state.pos, N_MAIN, 2, cfg.size)
    m = result.monitors
    if int(m.migrate_dropped) != 0:
        raise AssertionError(f"dirs9 run dropped {int(m.migrate_dropped)}")
    warm = cfg.rebin_every  # timed_run's untimed warm-up period
    want = [STEPS_MAIN + warm, 1] + [STEPS_MAIN // CADENCE_MAIN + 1] * 2
    if launches9 != want:
        raise AssertionError(f"launches (grid_step, grid_force, rebin_counts, "
                             f"rebin_shuffle) {launches9}, expected {want}")
    # K6 against its twin on this state too: the step-11 slab of phase 7
    # still holds the init lattice, with few pairs in cutoff
    err6 = max(k6_compare(f"final dirs9 state ({STEPS_MAIN} steps)", slab,
                          engine.geom, c) for c in (cfg, cfg.with_(force_law="lj", dt=1e-4)))
    k6["max_abs_err"] = max(k6["max_abs_err"], err6)
    live = slab.pid >= 0
    net = [float(a[live].double().sum()) for a in (ax, ay)]
    total = [float(a[live].double().abs().sum()) for a in (ax, ay)]
    if any(abs(n) > NEWTON3_RTOL * t for n, t in zip(net, total)) or min(total) <= 0:
        raise AssertionError(f"Newton 3: net force {net} against summed |a| "
                             f"{total} (limit {NEWTON3_RTOL:g})")
    log(f"  n={N_MAIN} steps={STEPS_MAIN} rebin_every={CADENCE_MAIN} "
        f"capacity={engine.capacity} dirs9: {seconds:.4f} s = "
        f"{N_MAIN * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s; axes "
        f"(phase 3, same process): {axes_seconds:.4f} s; dirs9 / axes = "
        f"{seconds / axes_seconds:.4f} ({smi})")
    log(f"  monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} "
        f"deferred {int(m.deferred)}")
    log(f"  launches: grid_step {launches9[0]} (schedule {STEPS_MAIN} + {warm} "
        f"warm-up), rebin_counts {launches9[2]}, rebin_shuffle {launches9[3]} "
        f"(schedule {STEPS_MAIN // CADENCE_MAIN} + 1 warm-up), grid_force "
        f"{launches9[1]} (accel_of on the final state)")
    log(f"  every pid 0..{N_MAIN - 1} in exactly one slot")
    log(f"  Newton 3 on the final state (K6 via accel_of): net force "
        f"({net[0]:.6g}, {net[1]:.6g}) against summed |a| ({total[0]:.6g}, "
        f"{total[1]:.6g})")
    k6["ms_late"] = late_ms(lambda: grid_force_cuda(
        slab.xl, slab.yl, engine.geom, cfg.cutoff, cfg.min_r, cfg.mass))
    log(f"  K6 on the final dirs9 state: {k6['ms_late']:.4f} ms/call "
        f"(step-11 slab {k6['ms']:.4f}; {smi})")
    # K7 and K8 on the final state: the late-run slab, rebinned 91 times
    geom9, evac9 = engine.geom, cfg.evac_capacity
    k78_compare(f"final dirs9 state ({STEPS_MAIN} steps)", slab, geom9, evac9)
    counts = rebin_counts_cuda(slab, geom9)
    k7["ms_late"] = late_ms(lambda: rebin_counts_cuda(slab, geom9))
    k8["ms_late"] = late_ms(lambda: rebin_shuffle_cuda(slab, counts, geom9, evac9))
    log(f"  K7, K8 on the final dirs9 state: {k7['ms_late']:.4f}, "
        f"{k8['ms_late']:.4f} ms/call (step-11 slab {k7['ms']:.4f}, "
        f"{k8['ms']:.4f}; bounds there {k7['bound_ms']:.4f}, "
        f"{k8['bound_ms']:.4f}; {smi})")
    del result, slab, ax, ay, live, counts
    for mode in ("axes", "dirs9"):
        eng_pt = get_engine("cuda", cfg.with_(grid_rebin_mode=mode), device=dev)
        pt = phase_times(eng_pt, state, steps=50)
        log(f"  phase_times cuda {mode} (ms/step; {smi}): " + ", ".join(
            f"{k} {1e3 * v:.4f}" for k, v in pt.items()))
        del eng_pt
    torch.cuda.empty_cache()
    phase_line("9", "dirs9 at full width clean", t0)


def shard_forms(name, slab, geom, cfg, with_k1: bool):
    """K1 (if ``with_k1``), K2, K7 and K8 in their shard forms on the
    ``SHARDS`` shards of ``slab`` (``LocalMesh``: each shard its own tensors,
    ghost rows copied by the mesh) against their twins and against the rows
    of the single-device kernels' output on the whole slab. Returns K1's
    largest difference from its twin and, per kernel, the calls on shard 1
    (ghosts on both sides) for the timings: (shard form, twin with ghosts,
    single-device call on the same rows)."""
    import torch

    from ppsim_tpu_torch.engines.mesh import LocalMesh
    from ppsim_tpu_torch.ops.binning import BIG
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_axes_call_cuda, rebin_axes_call_plain, rebin_counts_cuda,
        rebin_counts_plain, rebin_shuffle_cuda, rebin_shuffle_plain,
    )
    from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabState, monitors_of_counts

    P, evac = SHARDS, cfg.evac_capacity
    mesh = LocalMesh(P, slab.xl.device)
    rl = slab.xl.shape[1] // P
    shards = [SlabState(*fs) for fs in zip(*(mesh.split(f) for f in slab))]

    def rows(t, d):
        return t[:, d * rl:(d + 1) * rl] if t.dim() == 3 else t[d * rl:(d + 1) * rl]

    def compare(label, d, got, want, whole):
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            assert_equal(f"{label} {name} shard {d} output {k}", g, w)
            assert_equal(f"{label} {name} shard {d} output {k} vs single device",
                         g, rows(f, d))

    calls, err1 = {}, 0.0
    if with_k1:
        a1 = (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size)
        whole = grid_step_cuda(*slab[:4], *a1)
        gx, gy = (mesh.halo([s[k] for s in shards], BIG, 1, 1) for k in (0, 1))
        for d, s in enumerate(shards):
            kw = dict(row0=d * rl, ghosts=(gx[d][0], gy[d][0], gx[d][1], gy[d][1]))
            got = grid_step_cuda(*s[:4], *a1, **kw)
            want = grid_step_plain(*s[:4], *a1, **kw)
            for p, g, w, f in zip(("xl", "yl", "vx", "vy", "speed2"), got, want, whole):
                err1 = max(err1, assert_close(f"K1 {name} shard {d} {p}", g, w,
                                              K1_RTOL, K1_ATOL))
                assert_equal(f"K1 {name} shard {d} {p} vs single device", g, rows(f, d))
            if d == 1:
                calls["k1"] = (lambda s=s, kw=kw: grid_step_cuda(*s[:4], *a1, **kw),
                               lambda s=s, kw=kw: grid_step_plain(*s[:4], *a1, **kw),
                               lambda s=s: grid_step_cuda(*s[:4], *a1))
        del whole
    whole = rebin_axes_call_cuda(slab, geom, evac)
    halos = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 2 if k in (0, 4) else 1)
             for k in range(5)]
    for d, s in enumerate(shards):
        kw = dict(row0=d * rl, field_ghosts=[h[d] for h in halos])
        got, cnt = rebin_axes_call_cuda(s, geom, evac, **kw)
        want, wcnt = rebin_axes_call_plain(s, geom, evac, **kw)
        compare("K2", d, (*got, cnt), (*want, wcnt), (*whole[0], whole[1]))
        if d == 1:
            calls["k2"] = (lambda s=s, kw=kw: rebin_axes_call_cuda(s, geom, evac, **kw),
                           lambda s=s, kw=kw: rebin_axes_call_plain(s, geom, evac, **kw),
                           lambda s=s: rebin_axes_call_cuda(s, geom, evac))
    mon2 = [int(v) for v in monitors_of_counts(whole[1])]
    del whole
    wcounts = rebin_counts_cuda(slab, geom)
    whole = rebin_shuffle_cuda(slab, wcounts, geom, evac)
    counts = [rebin_counts_cuda(s, geom, row0=d * rl) for d, s in enumerate(shards)]
    fh = [mesh.halo([s[k] for s in shards], SLAB_FILLS[k], 1, 1) for k in range(5)]
    ch = mesh.halo(counts, 0, 2, 2)
    for d, s in enumerate(shards):
        compare("K7", d, (counts[d],), (rebin_counts_plain(s, geom, row0=d * rl),),
                (wcounts,))
        kw = dict(row0=d * rl, field_ghosts=[h[d] for h in fh], count_ghosts=ch[d])
        got, cnt = rebin_shuffle_cuda(s, counts[d], geom, evac, **kw)
        want, wcnt = rebin_shuffle_plain(s, counts[d], geom, evac, **kw)
        compare("K8", d, (*got, cnt), (*want, wcnt), (*whole[0], whole[1]))
        if d == 1:
            c0 = rebin_counts_cuda(s, geom)
            calls["k7"] = (lambda s=s: rebin_counts_cuda(s, geom, row0=rl),
                           lambda s=s: rebin_counts_plain(s, geom, row0=rl),
                           lambda s=s: rebin_counts_cuda(s, geom))
            calls["k8"] = (
                lambda s=s, c=counts[d], kw=kw: rebin_shuffle_cuda(s, c, geom, evac, **kw),
                lambda s=s, c=counts[d], kw=kw: rebin_shuffle_plain(s, c, geom, evac, **kw),
                lambda s=s, c=c0: rebin_shuffle_cuda(s, c, geom, evac))
    mon9 = [int(v) for v in monitors_of_counts(whole[1])]
    log(f"  shard forms, {name} ({P} shards of {rl} rows, real ghost rows): "
        + (f"K1 allclose to its twin (rtol {K1_RTOL:g}, atol {K1_ATOL:g}; max abs "
           f"diff {err1:.3e}) and bitwise equal to the single-device K1's rows; "
           if with_k1 else "")
        + "K2, K7, K8 bitwise equal to their twins and to the single-device "
        f"kernels' rows; monitors (max_occ, dropped, deferred) axes {mon2}, "
        f"dirs9 {mon9}")
    return err1, calls


def phase_sharded(kernels, state, cfg, ref3, smi: str):
    """Phase 10: the shard forms of K1, K2, K7 and K8 and the sharded engine
    at full width. Fills the shard-form records of ``kernels``; ``ref3`` is
    phase 3's (final ParticleState, seconds). Returns the single-device dirs9
    run of 10c: (final ParticleState, monitors, seconds)."""
    import torch

    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.profiling import profile_steps
    from ppsim_tpu_torch.testing import SHARD_EDGE_GEOMETRY, shard_edge_slab

    dev = torch.device("cuda", 0)
    P = SHARDS
    recs = {k: kernels[f"{name}_shard"] for k, name in (
        ("k1", "grid_step"), ("k2", "rebin_axes"), ("k7", "rebin_counts"),
        ("k8", "rebin_shuffle"))}

    # ---- (a) the shard forms against their twins and the single device ----
    t0 = time.perf_counter()
    eng = get_engine("cuda", cfg, device=dev)
    geom = eng.geom
    carry = eng.init_carry(state)
    for _ in range(CADENCE_MAIN):
        carry = eng.step_plain(carry)
    slab11 = carry.slab
    del carry, eng
    err1, calls = shard_forms(f"main-path slab after {CADENCE_MAIN} steps", slab11,
                              geom, cfg, with_k1=True)
    ge = SHARD_EDGE_GEOMETRY
    for contention in (False, True):
        shard_forms("shard-edge slab" + (" (contention)" if contention else ""),
                    shard_edge_slab(ge, P, seed=1, contention=contention, device=dev),
                    ge, cfg.with_(evac_capacity=2), with_k1=False)
    recs["k1"]["max_abs_err"] = err1
    for k in ("k2", "k7", "k8"):
        recs[k]["max_abs_err"] = 0.0
    # times on shard 1 (416 rows, ghosts on both sides): the shard form, the
    # single-device call on the same rows (no ghosts), the twin with ghosts
    times = {}
    for k, (shard_fn, plain_fn, single_fn) in calls.items():
        a = [cuda_ms(shard_fn, 20), cuda_ms(single_fn, 20)]
        a += [cuda_ms(shard_fn, 20), cuda_ms(single_fn, 20)]
        times[k] = (min(a[0], a[2]), min(a[1], a[3]), cuda_ms(plain_fn, 2))
    # bounds on shard 1 of this slab: the single-device bytes of its rows
    # plus the ghost rows read (K1: 2 planes x 2 rows; K2: 5 planes above,
    # 7 rows below; K8: 5 field planes x 2 rows and 9 count planes x 4)
    rl = geom.rows_pad // P
    s1 = slab11.pid[:, rl:2 * rl]
    plane_b = 4 * s1.numel()
    bin_b = plane_b // geom.capacity
    row_b = 4 * geom.capacity * geom.cols_pad
    ext = slab11.pid[:, rl - 1:2 * rl + 1]
    pairs1 = (candidate_pairs(ext) - candidate_pairs(ext[:, :1])
              - candidate_pairs(ext[:, -1:]))
    for k, nbytes, flops in (
            ("k1", 8 * plane_b + bin_b + 4 * row_b, 5 * pairs1),
            ("k2", 10 * plane_b + 4 * bin_b + 12 * row_b, 0),
            ("k7", 3 * plane_b + 9 * bin_b, 0),
            ("k8", 10 * plane_b + 13 * bin_b + 10 * row_b
             + 36 * row_b // geom.capacity, 0)):
        bound, by = bound_of(nbytes, flops)
        recs[k].update(ms=times[k][0], plain_ms=times[k][2], bound_ms=bound,
                       bound_by=by, ms_single_same_rows=times[k][1])
    whole_ms = {"k1": kernels["grid_step"]["ms"], "k2": kernels["rebin_axes"]["ms"],
                "k7": kernels["rebin_counts"]["ms"], "k8": kernels["rebin_shuffle"]["ms"]}
    log(f"  times on shard 1 of {P} ({rl} x {geom.cols_pad} x {geom.capacity}; "
        f"ms/call; {smi}): " + "; ".join(
            f"{k.upper()} shard form {t[0]:.4f}, single-device call on the same rows "
            f"{t[1]:.4f}, whole slab / {P} {whole_ms[k] / P:.4f}, twin {t[2]:.3f}, "
            f"bound {recs[k]['bound_ms']:.4f}" for k, t in times.items()))
    del slab11, calls
    torch.cuda.empty_cache()
    phase_line("10a", "shard forms agree with their twins and the single device", t0)

    # ---- (b) the main path on sharded_grid at full width -------------------
    t0 = time.perf_counter()
    engine = get_engine("sharded_grid", cfg, device=dev, shards=P)
    # the single-device grid, rows padded to P strips of a multiple of 8
    # (at full width 1664 = 4 x 416: no padding)
    if (engine.geom.rows, engine.geom.cols_pad, engine.geom.capacity) != (
            geom.rows, geom.cols_pad, geom.capacity):
        raise AssertionError(f"sharded geometry {engine.geom} differs from {geom}")
    for k in ("k1", "k2"):
        recs[k]["wrapper"].launches = 0
    result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
    for k in ("k1", "k2"):
        recs[k]["launches"] = recs[k]["wrapper"].launches
    engine.check(result)
    check_final(engine.full_slab(result.carry), result.state.pos, N_MAIN, 2, cfg.size)
    warm = cfg.rebin_every
    want = (P * (STEPS_MAIN + warm), P * (STEPS_MAIN // CADENCE_MAIN + 1))
    if (recs["k1"]["launches"], recs["k2"]["launches"]) != want:
        raise AssertionError(f"launches {recs['k1']['launches']}, "
                             f"{recs['k2']['launches']}, expected {want}")
    final_frame_check("the sharded main path", result.state.pos, cfg)
    ref_state, ref_seconds = ref3
    assert_equal("sharded main path pos vs phase 3", result.state.pos, ref_state.pos)
    assert_equal("sharded main path vel vs phase 3", result.state.vel, ref_state.vel)
    m = result.monitors
    log(f"  sharded_grid ({P} shards of {engine.rows_local} rows, LocalMesh) n={N_MAIN} "
        f"steps={STEPS_MAIN} rebin_every={CADENCE_MAIN} axes: {seconds:.4f} s = "
        f"{N_MAIN * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s; cuda "
        f"(phase 3, same process): {ref_seconds:.4f} s; sharded / single = "
        f"{seconds / ref_seconds:.4f} ({smi})")
    log(f"  final state bitwise equal to phase 3's (positions and velocities); "
        f"monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} deferred "
        f"{int(m.deferred)}")
    log(f"  launches: grid_step {recs['k1']['launches']}, rebin_axes "
        f"{recs['k2']['launches']} ({P} shards x the schedule {STEPS_MAIN} + {warm} "
        f"warm-up and {STEPS_MAIN // CADENCE_MAIN} + 1 warm-up)")
    log(f"  every pid 0..{N_MAIN - 1} in exactly one slot")
    carry = result.carry
    del result
    _, win = profile_steps(engine, carry, STEPS_MAIN + 1, 2 * CADENCE_MAIN)
    log(f"  torch.profiler, sharded main path, steps {win.steps.start}-"
        f"{win.steps.stop - 1} ({smi}):")
    for line in win.table(top=14).splitlines():
        log(f"    {line}")
    del carry, engine
    torch.cuda.empty_cache()
    phase_line("10b", "sharded main path at full width clean", t0)

    # ---- (c) dirs9 on sharded_grid ----------------------------------------
    t0 = time.perf_counter()
    cfg9 = cfg.with_(grid_rebin_mode="dirs9")
    ref9, ref9_seconds = timed_run(get_engine("cuda", cfg9, device=dev), state,
                                   STEPS_DIRS9_SHARDED, 0)
    engine = get_engine("sharded_grid", cfg9, device=dev, shards=P)
    path = ("k1", "k7", "k8")
    for k in path:
        recs[k]["wrapper"].launches = 0
    result, seconds = timed_run(engine, state, STEPS_DIRS9_SHARDED, 0)
    launches = [recs[k]["wrapper"].launches for k in path]
    for k in ("k7", "k8"):
        recs[k]["launches"] = recs[k]["wrapper"].launches
    engine.check(result)
    check_final(engine.full_slab(result.carry), result.state.pos, N_MAIN, 2, cfg.size)
    nreb = STEPS_DIRS9_SHARDED // CADENCE_MAIN + 1
    want = [P * (STEPS_DIRS9_SHARDED + warm), P * nreb, P * nreb]
    if launches != want:
        raise AssertionError(f"dirs9 launches {launches}, expected {want}")
    final_frame_check("the sharded dirs9 run", result.state.pos, cfg)
    assert_equal("sharded dirs9 pos vs cuda", result.state.pos, ref9.state.pos)
    assert_equal("sharded dirs9 vel vs cuda", result.state.vel, ref9.state.vel)
    if [float(v) for v in result.monitors] != [float(v) for v in ref9.monitors]:
        raise AssertionError(f"dirs9 monitors {result.monitors} vs {ref9.monitors}")
    m = result.monitors
    log(f"  sharded_grid dirs9 ({P} shards) n={N_MAIN} steps={STEPS_DIRS9_SHARDED}: "
        f"{seconds:.4f} s; cuda dirs9 (same process): {ref9_seconds:.4f} s; final "
        f"state and monitors bitwise equal to the cuda run's (max_bin_count "
        f"{int(m.max_bin_count)} dropped {int(m.migrate_dropped)} deferred "
        f"{int(m.deferred)}); launches grid_step {launches[0]}, rebin_counts "
        f"{launches[1]}, rebin_shuffle {launches[2]} ({smi})")
    ref9 = (ref9.state, ref9.monitors, ref9_seconds)
    del result, engine
    torch.cuda.empty_cache()
    phase_line("10c", "sharded dirs9 clean", t0)
    return ref9


def shard_forms3(name, slab, geom, cfg, with_k3: bool):
    """K3 (if ``with_k3``), K4 and K5 in their shard forms on the ``SHARDS``
    y strips of ``slab`` (``LocalMesh``: each shard its own tensors, ghost
    slabs copied by the mesh) against their twins and against the rows of
    the single-device kernels' output on the whole slab. Returns K3's
    largest difference from its twin and, per kernel, the calls on shard 1
    (ghosts on both sides) for the timings: (shard form, twin with ghosts,
    single-device call on the same slabs)."""
    from ppsim_tpu_torch.engines.mesh import LocalMesh
    from ppsim_tpu_torch.ops.binning import BIG
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin3 import (
        ALIVE_PRE, FAR_PRE, rebin3_inplane_cuda, rebin3_inplane_plain,
        rebin3_ypass_cuda, rebin3_ypass_plain,
    )
    from ppsim_tpu_torch.ops.grid3d_ops import FILLS3, Slab3State, rebin3_monitors

    P, evac = SHARDS, cfg.evac_capacity
    mesh = LocalMesh(P, slab.xl.device)
    yl = slab.xl.shape[1] // P
    shards = [Slab3State(*fs) for fs in zip(*(mesh.split(f) for f in slab))]

    def rows(t, d):
        return t[:, d * yl:(d + 1) * yl] if t.dim() == 4 else t[d * yl:(d + 1) * yl]

    def compare(label, d, got, want, whole):
        for k, (g, w, f) in enumerate(zip(got, want, whole)):
            assert_equal(f"{label} {name} shard {d} output {k}", g, w)
            assert_equal(f"{label} {name} shard {d} output {k} vs single device",
                         g, rows(f, d))

    calls, err3 = {}, 0.0
    if with_k3:
        a3 = (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size, cfg.force_law,
              cfg.law_params)
        whole = grid3_step_cuda(*slab[:6], *a3)
        halos = [mesh.halo([s[k] for s in shards], BIG, 1, 1) for k in range(3)]
        for d, s in enumerate(shards):
            kw = dict(y0=d * yl, ghosts=tuple(h[d][0] for h in halos)
                      + tuple(h[d][1] for h in halos))
            got = grid3_step_cuda(*s[:6], *a3, **kw)
            want = grid3_step_plain(*s[:6], *a3, **kw)
            for p, g, w, f in zip(("xl", "yl", "zl", "vx", "vy", "vz", "speed2"),
                                  got, want, whole):
                err3 = max(err3, assert_close(f"K3 {name} shard {d} {p}", g, w,
                                              K3_RTOL, K3_ATOL))
                assert_equal(f"K3 {name} shard {d} {p} vs single device", g, rows(f, d))
            del want
            if d == 1:
                calls["k3"] = (lambda s=s, kw=kw: grid3_step_cuda(*s[:6], *a3, **kw),
                               lambda s=s, kw=kw: grid3_step_plain(*s[:6], *a3, **kw),
                               lambda s=s: grid3_step_cuda(*s[:6], *a3))
        del whole
    wmid, wcnt = rebin3_inplane_cuda(slab, geom, evac)
    whole = rebin3_ypass_cuda(wmid, wcnt, geom, evac)
    mon = [int(v) for v in rebin3_monitors(wcnt[FAR_PRE], wcnt[ALIVE_PRE], whole[1])]
    mids = [rebin3_inplane_cuda(s, geom, evac, y0=d * yl) for d, s in enumerate(shards)]
    for d, (s, (mid, cnt)) in enumerate(zip(shards, mids)):
        want, wc = rebin3_inplane_plain(s, geom, evac, y0=d * yl)
        compare("K4", d, (*mid, cnt), (*want, wc), (*wmid, wcnt))
        if d == 1:
            calls["k4"] = (lambda s=s: rebin3_inplane_cuda(s, geom, evac, y0=yl),
                           lambda s=s: rebin3_inplane_plain(s, geom, evac, y0=yl),
                           lambda s=s: rebin3_inplane_cuda(s, geom, evac))
    del wmid, wcnt
    fh = [mesh.halo([m[k] for m, _ in mids], FILLS3[k], 1, 1) for k in range(7)]
    ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
    for d, (mid, cnt) in enumerate(mids):
        kw = dict(y0=d * yl, field_ghosts=[h[d] for h in fh], count_ghosts=ch[d])
        got, post = rebin3_ypass_cuda(mid, cnt, geom, evac, **kw)
        want, wpost = rebin3_ypass_plain(mid, cnt, geom, evac, **kw)
        compare("K5", d, (*got, post), (*want, wpost), (*whole[0], whole[1]))
        if d == 1:
            c0 = rebin3_inplane_cuda(shards[1], geom, evac)[1]
            calls["k5"] = (
                lambda m=mid, c=cnt, kw=kw: rebin3_ypass_cuda(m, c, geom, evac, **kw),
                lambda m=mid, c=cnt, kw=kw: rebin3_ypass_plain(m, c, geom, evac, **kw),
                lambda m=mid, c=c0: rebin3_ypass_cuda(m, c, geom, evac))
    log(f"  3D shard forms, {name} ({P} shards of {yl} y slabs, real ghost slabs): "
        + (f"K3 allclose to its twin (rtol {K3_RTOL:g}, atol {K3_ATOL:g}; max abs "
           f"diff {err3:.3e}) and bitwise equal to the single-device K3's rows; "
           if with_k3 else "")
        + "K4, K5 bitwise equal to their twins and to the single-device kernels' "
        f"rows (count and post planes included); monitors (max_occ, dropped, "
        f"deferred) {mon}")
    return err3, calls


def phase_sharded3d(kernels, state3, ref6, smi: str) -> None:
    """Phase 11: the shard forms of K3, K4 and K5 and the 3D sharded engine
    at full width. Fills the 3D shard-form records of ``kernels``;
    ``state3`` is the stretch config's initial state and ``ref6`` phase 6's
    (final ParticleState, seconds)."""
    import torch

    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.engines.mesh import LocalMesh
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.ops.binning import BIG
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda
    from ppsim_tpu_torch.ops.cuda_rebin3 import rebin3_inplane_cuda, rebin3_ypass_cuda
    from ppsim_tpu_torch.ops.grid3d_ops import FILLS3
    from ppsim_tpu_torch.profiling import profile_steps
    from ppsim_tpu_torch.testing import SHARD_EDGE_GEOMETRY3, shard_edge_slab3

    dev = torch.device("cuda", 0)
    P = SHARDS
    recs = {k: kernels[f"{name}_shard"] for k, name in (
        ("k3", "grid3_step"), ("k4", "rebin3_inplane"), ("k5", "rebin3_ypass"))}

    # ---- (a) the shard forms against their twins and the single device ----
    t0 = time.perf_counter()
    cfg3 = SimConfig(**STRETCH)
    eng = get_engine("cuda3d", cfg3, device=dev)
    geom = eng.geom
    carry = eng.init_carry(state3)
    for _ in range(eng.rebin_every):
        carry = eng.step_plain(carry)
    slab8 = carry.slab
    del carry, eng
    err3, calls = shard_forms3(f"stretch slab after {geom.cadence(cfg3)} steps", slab8,
                               geom, cfg3, with_k3=True)
    ge = SHARD_EDGE_GEOMETRY3
    for contention in (False, True):
        shard_forms3("shard-edge slab" + (" (contention)" if contention else ""),
                     shard_edge_slab3(ge, P, seed=1, contention=contention, device=dev),
                     ge, cfg3.with_(evac_capacity=2), with_k3=False)
    recs["k3"]["max_abs_err"] = err3
    recs["k4"]["max_abs_err"] = recs["k5"]["max_abs_err"] = 0.0
    # times on shard 1 (35 slabs, ghosts on both sides): the shard form and
    # the single-device call on the same slabs (no ghosts) in turns, the twin
    times = {}
    for k, (shard_fn, plain_fn, single_fn) in calls.items():
        a = [cuda_ms(shard_fn, 10), cuda_ms(single_fn, 10)]
        a += [cuda_ms(shard_fn, 10), cuda_ms(single_fn, 10)]
        times[k] = (min(a[0], a[2]), min(a[1], a[3]), cuda_ms(plain_fn, 1))
    # bounds on shard 1 of this slab: the single-device bytes of its slabs
    # plus the ghost slabs read (K3: 3 planes x 2 slabs; K5: 7 planes x 2
    # slabs and the count planes [m-, alive] x 3 slabs)
    yl = geom.ys_pad // P
    s1 = slab8.pid[:, yl:2 * yl]
    plane_b = 4 * s1.numel()
    bin_b = plane_b // geom.capacity
    ys_b = 4 * geom.capacity * geom.xs_pad * geom.zs_pad  # one slab of one field
    ext = slab8.pid[:, yl - 1:2 * yl + 1]
    pairs1 = (candidate_pairs(ext) - candidate_pairs(ext[:, :1])
              - candidate_pairs(ext[:, -1:]))
    for k, nbytes, flops in (
            ("k3", 12 * plane_b + bin_b + 6 * ys_b, 8 * pairs1),
            ("k4", 14 * plane_b + 5 * bin_b, 0),
            ("k5", 14 * plane_b + 4 * bin_b + 14 * ys_b + 6 * ys_b // geom.capacity, 0)):
        bound, by = bound_of(nbytes, flops)
        recs[k].update(ms=times[k][0], plain_ms=times[k][2], bound_ms=bound,
                       bound_by=by, ms_single_same_rows=times[k][1])
    whole_ms = {"k3": kernels["grid3_step"]["ms"], "k4": kernels["rebin3_inplane"]["ms"],
                "k5": kernels["rebin3_ypass"]["ms"]}
    log(f"  times on shard 1 of {P} ({yl} x {geom.xs_pad} x {geom.zs_pad} x "
        f"{geom.capacity}; ms/call; {smi}): " + "; ".join(
            f"{k.upper()} shard form {t[0]:.4f}, single-device call on the same slabs "
            f"{t[1]:.4f}, whole slab / {P} {whole_ms[k] / P:.4f}, twin {t[2]:.3f}, "
            f"bound {recs[k]['bound_ms']:.4f}" for k, t in times.items()))
    del slab8, calls, s1, ext
    torch.cuda.empty_cache()
    phase_line("11a", "3D shard forms agree with their twins and the single device", t0)

    # ---- (b) the stretch config on sharded_grid3d at full width ------------
    t0 = time.perf_counter()
    n3 = cfg3.num_parts
    engine = get_engine("sharded_grid3d", cfg3, device=dev, shards=P)
    # the single-device grid in P strips (at full width 140 = 4 x 35: no
    # padding)
    g = engine.geom
    if (g.ys, g.ys_pad, g.xs_pad, g.zs_pad, g.capacity) != (
            geom.ys, geom.ys_pad, geom.xs_pad, geom.zs_pad, geom.capacity):
        raise AssertionError(f"sharded geometry {g} differs from {geom}")
    for k in recs.values():
        k["wrapper"].launches = 0
    result, seconds = timed_run(engine, state3, STEPS_MAIN, 0)
    for k in recs.values():
        k["launches"] = k["wrapper"].launches
    engine.check(result)
    check_final(engine.full_slab(result.carry), result.state.pos, n3, 3, cfg3.size)
    cadence = engine.rebin_every
    want = [P * (STEPS_MAIN + cadence)] + [P * (STEPS_MAIN // cadence + 1)] * 2
    got = [recs[k]["launches"] for k in ("k3", "k4", "k5")]
    if got != want:
        raise AssertionError(f"launches (K3, K4, K5) {got}, expected {want}")
    final_frame_check("the sharded stretch config", result.state.pos, cfg3)
    ref_state, ref_seconds = ref6
    assert_equal("sharded stretch pos vs phase 6", result.state.pos, ref_state.pos)
    assert_equal("sharded stretch vel vs phase 6", result.state.vel, ref_state.vel)
    m = result.monitors
    log(f"  sharded_grid3d ({P} shards of {engine.ys_local} y slabs, LocalMesh) "
        f"n={n3} 3D LJ steps={STEPS_MAIN} rebin_every={cadence}: {seconds:.4f} s = "
        f"{n3 * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s; cuda3d (phase 6, "
        f"same process): {ref_seconds:.4f} s; sharded / single = "
        f"{seconds / ref_seconds:.4f} ({smi})")
    log(f"  final state bitwise equal to phase 6's (positions and velocities); "
        f"monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} deferred "
        f"{int(m.deferred)}")
    log(f"  launches: grid3_step {got[0]}, rebin3_inplane {got[1]}, rebin3_ypass "
        f"{got[2]} ({P} shards x the schedule {STEPS_MAIN} + {cadence} warm-up and "
        f"{STEPS_MAIN // cadence} + 1 warm-up)")
    log(f"  every pid 0..{n3 - 1} in exactly one slot")
    carry = result.carry
    del result
    # the shard forms on shard 1 of the final state: the late-run slabs
    shards = carry.slab
    mesh = LocalMesh(P, dev)
    s = shards[1]
    y0 = engine.y0(1)
    halos = [mesh.halo([t[k] for t in shards], BIG, 1, 1) for k in range(3)]
    ghosts = tuple(h[1][0] for h in halos) + tuple(h[1][1] for h in halos)
    a3 = (g, cfg3.cutoff, cfg3.min_r, cfg3.mass, cfg3.dt, cfg3.size, cfg3.force_law,
          cfg3.law_params)
    recs["k3"]["ms_late"] = late_ms(lambda: grid3_step_cuda(*s[:6], *a3, y0=y0,
                                                            ghosts=ghosts))
    mids = [rebin3_inplane_cuda(t, g, cfg3.evac_capacity, y0=engine.y0(d))
            for d, t in enumerate(shards)]
    recs["k4"]["ms_late"] = late_ms(lambda: rebin3_inplane_cuda(s, g, cfg3.evac_capacity,
                                                                y0=y0))
    fh = [mesh.halo([mm[k] for mm, _ in mids], FILLS3[k], 1, 1) for k in range(7)]
    ch = mesh.halo([c[:2] for _, c in mids], 0, 1, 2)
    recs["k5"]["ms_late"] = late_ms(lambda: rebin3_ypass_cuda(
        *mids[1], g, cfg3.evac_capacity, y0=y0, field_ghosts=[h[1] for h in fh],
        count_ghosts=ch[1]))
    log(f"  K3, K4, K5 shard forms on shard 1 of the final state: "
        f"{recs['k3']['ms_late']:.4f}, {recs['k4']['ms_late']:.4f}, "
        f"{recs['k5']['ms_late']:.4f} ms/call (step-8 slab {recs['k3']['ms']:.4f}, "
        f"{recs['k4']['ms']:.4f}, {recs['k5']['ms']:.4f}; {smi})")
    del mids, fh, ch, halos, ghosts, s, shards
    torch.cuda.empty_cache()
    _, win = profile_steps(engine, carry, STEPS_MAIN + 1, 2 * cadence)
    log(f"  torch.profiler, sharded stretch config, steps {win.steps.start}-"
        f"{win.steps.stop - 1} ({smi}):")
    for line in win.table(top=14).splitlines():
        log(f"    {line}")
    del carry, engine
    torch.cuda.empty_cache()
    phase_line("11b", "sharded stretch config at full width clean", t0)


def tile_forms(name, slab, geom, cfg, shape):
    """K1 and K2 in their tile forms on the tiles of ``slab`` (planes of the
    tile geometry ``geom``) cut on a ``shape`` mesh (``LocalMesh``: each tile
    its own tensors, the ghost ring copied by the mesh, rows first, so the
    corners come with the ghost columns) against their twins and against
    the bins of the single-device kernels' output on the whole slab. Returns
    K1's largest difference from its twin and, per kernel, the calls on
    the last tile (ghosts on its two inner sides) for the timings: (tile
    form, twin, single-device call on the same bins), and that tile's ghost
    ring of the K1 exchange."""
    from ppsim_tpu_torch.engines.mesh import LocalMesh
    from ppsim_tpu_torch.ops.binning import BIG
    from ppsim_tpu_torch.ops.cuda_grid import grid_step_cuda, grid_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin import rebin_axes_call_cuda, rebin_axes_call_plain
    from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabState

    evac = cfg.evac_capacity
    mesh = LocalMesh(shape, slab.xl.device)
    _, R, C = slab.xl.shape
    rl, cl = R // shape[0], C // shape[1]
    tiles = [SlabState(*fs) for fs in zip(*(mesh.split(f) for f in slab))]
    last = mesh.size - 1

    def offsets(d):
        r, c = mesh.coords(d)
        return r * rl, c * cl

    def bins(t, d):
        r0, c0 = offsets(d)
        return t[..., r0:r0 + rl, c0:c0 + cl]

    calls, err1 = {}, 0.0
    a1 = (geom, cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size)
    whole = grid_step_cuda(*slab[:4], *a1)
    gx, gy = (mesh.tile_halo([t[k] for t in tiles], BIG, 1, 1, 1, 1) for k in (0, 1))
    for d, t in enumerate(tiles):
        r0, c0 = offsets(d)
        (tx, bx, wx, ex), (ty, by, wy, ey) = gx[d], gy[d]
        kw = dict(row0=r0, ghosts=(tx, ty, bx, by), col0=c0, col_ghosts=(wx, wy, ex, ey))
        got = grid_step_cuda(*t[:4], *a1, **kw)
        want = grid_step_plain(*t[:4], *a1, **kw)
        for p, g, w, f in zip(("xl", "yl", "vx", "vy", "speed2"), got, want, whole):
            err1 = max(err1, assert_close(f"K1 tile {name} tile {d} {p}", g, w,
                                          K1_RTOL, K1_ATOL))
            assert_equal(f"K1 tile {name} tile {d} {p} vs single device", g, bins(f, d))
        if d == last:
            calls["k1"] = (lambda t=t, kw=kw: grid_step_cuda(*t[:4], *a1, **kw),
                           lambda t=t, kw=kw: grid_step_plain(*t[:4], *a1, **kw),
                           lambda t=t: grid_step_cuda(*t[:4], *a1))
    del whole
    whole, whole_cnt = rebin_axes_call_cuda(slab, geom, evac)
    halos = [mesh.tile_halo([t[k] for t in tiles], SLAB_FILLS[k], 1,
                            2 if k in (0, 4) else 1, 1, 2) for k in range(5)]
    for d, t in enumerate(tiles):
        r0, c0 = offsets(d)
        kw = dict(row0=r0, field_ghosts=[h[d][:2] for h in halos], col0=c0,
                  col_ghosts=[h[d][2:] for h in halos])
        got, cnt = rebin_axes_call_cuda(t, geom, evac, **kw)
        want, wcnt = rebin_axes_call_plain(t, geom, evac, **kw)
        for k, (g, w, f) in enumerate(zip((*got, cnt), (*want, wcnt), (*whole, whole_cnt))):
            assert_equal(f"K2 tile {name} tile {d} output {k}", g, w)
            assert_equal(f"K2 tile {name} tile {d} output {k} vs single device", g, bins(f, d))
        if d == last:
            calls["k2"] = (lambda t=t, kw=kw: rebin_axes_call_cuda(t, geom, evac, **kw),
                           lambda t=t, kw=kw: rebin_axes_call_plain(t, geom, evac, **kw),
                           lambda t=t: rebin_axes_call_cuda(t, geom, evac))
    log(f"  tile forms, {name} ({shape[0]} x {shape[1]} tiles of {rl} x {cl}, real ghost "
        f"rows, columns and corners): K1 allclose to its twin (rtol {K1_RTOL:g}, atol "
        f"{K1_ATOL:g}; max abs diff {err1:.3e}) and bitwise equal to the single-device "
        f"K1's bins; K2 bitwise equal to its twin and to the single-device K2's bins, "
        f"count planes included")
    return err1, calls, tiles[last].pid


def phase_tile(kernels, state, cfg, ref3, ref9, smi: str) -> None:
    """Phase 12: the tile forms of K1 and K2 and the 2-D tile engine at full
    width. Fills the tile-form records of ``kernels``; ``ref3`` is phase 3's
    (final ParticleState, seconds), ``ref9`` phase 10c's single-device dirs9
    run (final ParticleState, monitors, seconds)."""
    import torch

    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.ops.grid_ops import SLAB_FILLS, SlabState
    from ppsim_tpu_torch.profiling import profile_steps

    dev = torch.device("cuda", 0)
    recs = {"k1": kernels["grid_step_tile"], "k2": kernels["rebin_axes_tile"]}
    whole_ms = {"k1": kernels["grid_step"]["ms"], "k2": kernels["rebin_axes"]["ms"]}

    # ---- (a) the tile forms against their twins and the single device -----
    t0 = time.perf_counter()
    eng = get_engine("cuda", cfg, device=dev)
    carry = eng.init_carry(state)
    for _ in range(CADENCE_MAIN):
        carry = eng.step_plain(carry)
    slab11 = carry.slab
    del carry, eng
    err1, times = 0.0, {}
    for shape in TILE_MESHES:
        geom = get_engine("sharded_tile", cfg, device=dev, mesh_shape=shape).geom
        pad = geom.cols_pad - slab11.xl.shape[2]
        slab = SlabState(*(torch.cat([f, torch.full_like(f[..., :pad], fill)], 2)
                           for f, fill in zip(slab11, SLAB_FILLS)))
        e, calls, pid = tile_forms(f"main-path slab after {CADENCE_MAIN} steps", slab,
                                   geom, cfg, shape)
        err1 = max(err1, e)
        # times on the last tile: the tile form and the single-device call on
        # the same bins (no ghosts) in turns, the twin once
        t = {}
        for k, (tile_fn, plain_fn, single_fn) in calls.items():
            a = [cuda_ms(tile_fn, 20), cuda_ms(single_fn, 20)]
            a += [cuda_ms(tile_fn, 20), cuda_ms(single_fn, 20)]
            t[k] = (min(a[0], a[2]), min(a[1], a[3]), cuda_ms(plain_fn, 2))
        # bounds on that tile: the single-device bytes of its bins plus the
        # ghosts read (K1: 2 planes x (2 rows + 2 columns of R + 2); K2: rows
        # 5 planes above, 7 below, columns 5 planes x 3 of R + 2 and xl, pid
        # x 3 more); 5 flops a candidate pair of the tile and its ring
        cap, R, C = pid.shape
        plane_b = 4 * pid.numel()
        bin_b = plane_b // cap
        row_b, col_b = 4 * cap * C, 4 * cap * (R + 2)
        # the tile and its ring of the slab (the pairs of ring bins with
        # each other are not the tile's work)
        r0, c0 = (shape[0] - 1) * R, (shape[1] - 1) * C
        ext = slab.pid[:, max(r0 - 1, 0):r0 + R + 1, max(c0 - 1, 0):c0 + C + 1]
        top, left = int(r0 > 0), int(c0 > 0)
        bot, right = ext.shape[1] - top - R, ext.shape[2] - left - C
        pairs = candidate_pairs(ext)
        for part in ((ext[:, :top] if top else None), (ext[:, top + R:] if bot else None),
                     (ext[:, top:top + R, :left] if left else None),
                     (ext[:, top:top + R, left + C:] if right else None)):
            if part is not None:
                pairs -= candidate_pairs(part)
        for k, nbytes, flops in (
                ("k1", 8 * plane_b + bin_b + 4 * row_b + 4 * col_b, 5 * pairs),
                ("k2", 10 * plane_b + 4 * bin_b + 12 * row_b + 15 * col_b
                 + 6 * 4 * cap, 0)):
            bound, by = bound_of(nbytes, flops)
            t[k] += (bound, by)
        log(f"  times on the last tile of {shape[0]} x {shape[1]} ({R} x {C} x {cap}; "
            f"ms/call; {smi}): " + "; ".join(
                f"{k.upper()} tile form {v[0]:.4f}, single-device call on the same bins "
                f"{v[1]:.4f}, whole slab / 4 {whole_ms[k] / 4:.4f}, twin {v[2]:.3f}, "
                f"bound {v[3]:.4f} ({v[4]})" for k, v in t.items()))
        times[shape] = t
        del slab, calls, pid
        torch.cuda.empty_cache()
    for k in ("k1", "k2"):
        ms, single, plain, bound, by = times[TILE_MESHES[0]][k]
        recs[k].update(max_abs_err=err1 if k == "k1" else 0.0, ms=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, ms_single_same_bins=single,
                       ms_1x4=times[TILE_MESHES[1]][k][0])
    del slab11
    torch.cuda.empty_cache()
    phase_line("12a", "tile forms agree with their twins and the single device", t0)

    # ---- (b) the main path on sharded_tile at full width (2 x 2) -----------
    t0 = time.perf_counter()
    shape = TILE_MESHES[0]
    engine = get_engine("sharded_tile", cfg, device=dev, mesh_shape=shape)
    P = engine.mesh.size
    for k in ("k1", "k2"):
        recs[k]["wrapper"].launches = 0
    result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
    for k in ("k1", "k2"):
        recs[k]["launches"] = recs[k]["wrapper"].launches
    engine.check(result)
    check_final(engine.full_slab(result.carry), result.state.pos, N_MAIN, 2, cfg.size)
    warm = cfg.rebin_every
    want = (P * (STEPS_MAIN + warm), P * (STEPS_MAIN // CADENCE_MAIN + 1))
    if (recs["k1"]["launches"], recs["k2"]["launches"]) != want:
        raise AssertionError(f"launches {recs['k1']['launches']}, "
                             f"{recs['k2']['launches']}, expected {want}")
    final_frame_check("the tile main path", result.state.pos, cfg)
    ref_state, ref_seconds = ref3
    assert_equal("tile main path pos vs phase 3", result.state.pos, ref_state.pos)
    assert_equal("tile main path vel vs phase 3", result.state.vel, ref_state.vel)
    m = result.monitors
    g = engine.geom
    log(f"  sharded_tile ({shape[0]} x {shape[1]} tiles of {engine.rows_local} x "
        f"{engine.cols_local}, padded {g.rows_pad} x {g.cols_pad}, LocalMesh) n={N_MAIN} "
        f"steps={STEPS_MAIN} rebin_every={CADENCE_MAIN} axes: {seconds:.4f} s = "
        f"{N_MAIN * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s; cuda (phase 3, "
        f"same process): {ref_seconds:.4f} s; tiles / single = {seconds / ref_seconds:.4f} "
        f"({smi})")
    log(f"  final state bitwise equal to phase 3's (positions and velocities); "
        f"monitors: max_bin_count {int(m.max_bin_count)} dropped "
        f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} deferred "
        f"{int(m.deferred)}")
    log(f"  launches: grid_step {recs['k1']['launches']}, rebin_axes "
        f"{recs['k2']['launches']} ({P} tiles x the schedule {STEPS_MAIN} + {warm} "
        f"warm-up and {STEPS_MAIN // CADENCE_MAIN} + 1 warm-up)")
    log(f"  every pid 0..{N_MAIN - 1} in exactly one slot")
    carry = result.carry
    del result
    _, win = profile_steps(engine, carry, STEPS_MAIN + 1, 2 * CADENCE_MAIN)
    log(f"  torch.profiler, tile main path, steps {win.steps.start}-"
        f"{win.steps.stop - 1} ({smi}):")
    for line in win.table(top=14).splitlines():
        log(f"    {line}")
    del carry, engine
    torch.cuda.empty_cache()
    phase_line("12b", "tile main path at full width clean", t0)

    # ---- (c) dirs9 on the tile route ---------------------------------------
    t0 = time.perf_counter()
    cfg9 = cfg.with_(grid_rebin_mode="dirs9")
    engine = get_engine("sharded_tile", cfg9, device=dev, mesh_shape=shape)
    k1 = recs["k1"]["wrapper"]
    k1.launches = 0
    result, seconds = timed_run(engine, state, STEPS_DIRS9_SHARDED, 0)
    launches = k1.launches
    engine.check(result)
    check_final(engine.full_slab(result.carry), result.state.pos, N_MAIN, 2, cfg.size)
    if launches != P * (STEPS_DIRS9_SHARDED + warm):
        raise AssertionError(f"dirs9 tile route K1 launches {launches}")
    final_frame_check("the tile dirs9 run", result.state.pos, cfg)
    ref9_state, ref9_mon, ref9_seconds = ref9
    assert_equal("tile dirs9 pos vs cuda", result.state.pos, ref9_state.pos)
    assert_equal("tile dirs9 vel vs cuda", result.state.vel, ref9_state.vel)
    m = result.monitors
    for f in ("max_bin_count", "migrate_dropped"):
        if int(getattr(m, f)) != int(getattr(ref9_mon, f)):
            raise AssertionError(f"tile dirs9 {f} {int(getattr(m, f))} vs "
                                 f"{int(getattr(ref9_mon, f))}")
    log(f"  sharded_tile dirs9 ({shape[0]} x {shape[1]}, the torch ops on each tile's "
        f"2-bin ghost ring) n={N_MAIN} steps={STEPS_DIRS9_SHARDED}: {seconds:.4f} s; cuda "
        f"dirs9 (phase 10c, same process): {ref9_seconds:.4f} s; final state bitwise "
        f"equal to the cuda run's, max_bin_count {int(m.max_bin_count)} and dropped "
        f"{int(m.migrate_dropped)} equal; deferred {int(m.deferred)} (cuda "
        f"{int(ref9_mon.deferred)}); K1 tile launches {launches} ({smi})")
    carry = result.carry
    del result
    _, win = profile_steps(engine, carry, STEPS_DIRS9_SHARDED + 1, CADENCE_MAIN)
    log(f"  torch.profiler, tile dirs9 route, steps {win.steps.start}-"
        f"{win.steps.stop - 1}, one rebin ({smi}):")
    for line in win.table(top=10).splitlines():
        log(f"    {line}")
    del carry, engine
    torch.cuda.empty_cache()
    phase_line("12c", "tile dirs9 route clean", t0)


def phase_particle(state, ref3, state3, smi: str) -> None:
    """Phase 13: the particle-list engines on the card (plain PyTorch: they
    reach no TPU kernel, so no kernel of the port). ``state`` is the main
    path's initial state, ``ref3`` phase 3's (final ParticleState,
    seconds), ``state3`` the stretch config's initial state."""
    import numpy as np
    import torch

    from ppsim_tpu_torch import native
    from ppsim_tpu_torch.checker import frame_distance_stats
    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.profiling import profile_steps
    from ppsim_tpu_torch.state import make_state

    dev = torch.device("cuda", 0)
    t13 = time.perf_counter()

    # ---- (a) oracle against binned, bitwise; f64 oracle against native ----
    t0 = time.perf_counter()
    cfg_a = SimConfig(num_parts=N_ORACLE)
    st_a = init_particles(cfg_a, seed=SEED, method="reference", device=dev)
    runs = [get_engine(name, cfg_a, device=dev).run(st_a, nsteps=STEPS_ORACLE,
                                                     savefreq=10)
            for name in ("oracle", "binned")]
    differ = runs[0].frames != runs[1].frames
    if differ.any():
        raise AssertionError(
            f"oracle vs binned at n={N_ORACLE}: {int(differ.any(axis=2).sum())} "
            f"particle positions of {differ.shape[0]} frames differ (bitwise parity)")
    get_engine("binned", cfg_a, device=dev).check(runs[1])
    log(f"  oracle == binned bitwise, n={N_ORACLE}, {STEPS_ORACLE} steps, "
        f"{runs[0].frames.shape[0]} frames; binned max_bin_count "
        f"{int(runs[1].monitors.max_bin_count)}")
    cfg64 = SimConfig(num_parts=N_ORACLE64, dtype="float64")
    pos, vel = native.native_init(N_ORACLE64, cfg64.size, SEED)
    npos, _ = native.native_run(pos, vel, cfg64, STEPS_ORACLE64, engine="oracle")
    errs = {}
    for dt in ("float64", "float32"):
        c = cfg64.with_(dtype=dt)
        r = get_engine("oracle", c, device=dev).run(
            make_state(pos, vel, dtype=c.torch_dtype, device=dev), nsteps=STEPS_ORACLE64)
        if r.state.pos.dtype != c.torch_dtype:
            raise AssertionError(f"oracle {dt} ran in {r.state.pos.dtype}")
        errs[dt] = float(np.abs(r.state.pos.double().cpu().numpy() - npos).max())
    if errs["float64"] > ORACLE64_ATOL or errs["float32"] > ORACLE32_ATOL:
        raise AssertionError(f"oracle vs native ppsim_run_oracle: {errs}")
    log(f"  oracle vs native ppsim_run_oracle (float64, g++), n={N_ORACLE64}, "
        f"{STEPS_ORACLE64} steps: max |dpos| float64 {errs['float64']:.3e} (bound "
        f"{ORACLE64_ATOL:g}), float32 {errs['float32']:.3e} (bound {ORACLE32_ATOL:g})")
    del runs
    phase_line("13a", "oracle == binned bitwise; f64 oracle tracks the native oracle", t0)

    # ---- (b) binned at the main path's n ---------------------------------
    t0 = time.perf_counter()
    cfg_b = SimConfig(num_parts=N_MAIN)
    engine = get_engine("binned", cfg_b, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result, seconds = timed_run(engine, state, STEPS_PARTICLE, 0)
    peak = torch.cuda.max_memory_allocated(dev)
    engine.check(result)
    pid = result.carry.pid.long()
    if int(torch.bincount(pid, minlength=N_MAIN).max()) != 1 or pid.numel() != N_MAIN:
        raise AssertionError("binned: pid is not a permutation of 0..n-1")
    final_frame_check("the binned run", result.state.pos, cfg_b)
    ref_seconds = ref3[1]
    rate, rate3 = N_MAIN * STEPS_PARTICLE / seconds, N_MAIN * STEPS_MAIN / ref_seconds
    g, m = engine.geom, result.monitors
    log(f"  binned n={N_MAIN} steps={STEPS_PARTICLE} ({g.nrows} x {g.ncols} bins of "
        f"{g.bin_size:g}, capacity {g.capacity}): {seconds:.4f} s = {rate / 1e6:.2f} M "
        f"particle-steps/s ({1e3 * seconds / STEPS_PARTICLE:.3f} ms a step); cuda "
        f"(phase 3, same process): {rate3 / 1e6:.2f} M particle-steps/s "
        f"({1e3 * ref_seconds / STEPS_MAIN:.3f} ms a step); cuda / binned = "
        f"{rate3 / rate:.2f} ({smi})")
    log(f"  monitors: max_bin_count {int(m.max_bin_count)} (capacity {g.capacity}) "
        f"dropped {int(m.migrate_dropped)} deferred {int(m.deferred)}; pid a "
        f"permutation of 0..{N_MAIN - 1}; peak device memory {peak} bytes ({smi})")
    ref_b = result.state
    carry = result.carry
    del result
    _, win = profile_steps(engine, carry, STEPS_PARTICLE + 1, PROFILE_PARTICLE)
    log(f"  torch.profiler, binned, steps {win.steps.start}-{win.steps.stop - 1} ({smi}):")
    for line in win.table(top=10).splitlines():
        log(f"    {line}")
    del carry, engine
    torch.cuda.empty_cache()
    phase_line("13b", "binned at the main path's n clean", t0)

    # ---- (c) sharded on 4 in-process strips, bitwise = 13b ----------------
    t0 = time.perf_counter()
    engine = get_engine("sharded", cfg_b, device=dev, shards=SHARDS)
    result, seconds_c = timed_run(engine, state, STEPS_PARTICLE, 0)
    m = result.monitors
    if int(m.migrate_dropped) != 0:
        raise AssertionError(f"sharded dropped {int(m.migrate_dropped)} particles")
    differ = ((result.state.pos != ref_b.pos) | (result.state.vel != ref_b.vel)).any(dim=1)
    if bool(differ.any()):
        rows = (ref_b.pos[differ, 0] / cfg_b.bin_size).long().tolist()[:8]
        raise AssertionError(
            f"sharded vs binned: {int(differ.sum())} of {N_MAIN} particles differ in "
            f"position or velocity (bitwise parity); bin rows {rows}, strips of "
            f"{engine.rows_per_shard} rows")
    engine.check(result)
    log(f"  sharded ({SHARDS} strips of {engine.rows_per_shard} rows, slot pools of "
        f"{engine.n_cap}, LocalMesh) n={N_MAIN} steps={STEPS_PARTICLE}: "
        f"{seconds_c:.4f} s = {N_MAIN * STEPS_PARTICLE / seconds_c / 1e6:.2f} M "
        f"particle-steps/s; binned (13b): {seconds:.4f} s; sharded / binned = "
        f"{seconds_c / seconds:.4f} ({smi})")
    log(f"  final state bitwise equal to 13b's (positions and velocities); monitors: "
        f"max_bin_count {int(m.max_bin_count)} dropped {int(m.migrate_dropped)} "
        f"deferred {int(m.deferred)}")
    del result, engine, ref_b
    torch.cuda.empty_cache()
    phase_line("13c", "sharded == binned bitwise, nothing dropped", t0)

    # ---- (d) binned3d on the stretch config ------------------------------
    t0 = time.perf_counter()
    cfg_d = SimConfig(**STRETCH)
    engine = get_engine("binned3d", cfg_d, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result, seconds = timed_run(engine, state3, STEPS_BINNED3D, 0)
    engine.check(result)
    pid = result.carry.pid.long()
    if int(torch.bincount(pid, minlength=cfg_d.num_parts).max()) != 1:
        raise AssertionError("binned3d: pid is not a permutation of 0..n-1")
    final_frame_check("the binned3d stretch run", result.state.pos, cfg_d)
    g, m = engine.geom, result.monitors
    log(f"  binned3d, the stretch config (3D LJ, n={cfg_d.num_parts}, {g.nx}^3 bins of "
        f"{g.bin_size:g}, capacity {g.capacity}), {STEPS_BINNED3D} steps: {seconds:.4f} s "
        f"= {cfg_d.num_parts * STEPS_BINNED3D / seconds / 1e6:.2f} M particle-steps/s; "
        f"max_bin_count {int(m.max_bin_count)} dropped {int(m.migrate_dropped)}; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev)} bytes ({smi})")
    del result, engine
    torch.cuda.empty_cache()
    phase_line("13d", "binned3d stretch config clean", t0)

    # ---- (e) the CLI ------------------------------------------------------
    t0 = time.perf_counter()
    args = ["-n", "262144", "-s", str(SEED), "--steps", "200", "--engine", "binned",
            "--check"]
    run_clis([("binned CLI", args), ("binned CLI float64", args + ["--dtype", "float64"])])
    phase_line("13e", "binned CLI --check PASS, float32 and float64", t0)

    # ---- (f) binned3d against the 3D oracle, pairs in range --------------
    t0 = time.perf_counter()
    for law_kw in ({}, dict(force_law="lj", dt=1e-4)):
        cfg_f = SimConfig(**CFG_BINNED3D_ORACLE, **law_kw)
        st_f = init_particles(cfg_f, seed=SEED, method="fast", device=dev)
        r_o, r_b = (get_engine(name, cfg_f, device=dev).run(
            st_f, nsteps=STEPS_BINNED3D_ORACLE, savefreq=10) for name in ("oracle", "binned3d"))
        err = float(np.abs(r_b.frames - r_o.frames).max())
        pairs = [frame_distance_stats(f, cfg_f.cutoff)[2] for f in r_o.frames]
        if err > BINNED3D_ATOL or pairs[-1] == 0:
            raise AssertionError(f"binned3d vs oracle ({cfg_f.force_law}): max |dpos| "
                                 f"{err:.3e} (bound {BINNED3D_ATOL:g}); pairs in range "
                                 f"by frame {pairs}")
        get_engine("binned3d", cfg_f, device=dev).check(r_b)
        log(f"  binned3d vs oracle ({cfg_f.force_law}), n={cfg_f.num_parts}, "
            f"{STEPS_BINNED3D_ORACLE} steps, {r_o.frames.shape[0]} frames: max |dpos| "
            f"{err:.3e} (bound {BINNED3D_ATOL:g}); pairs in range by frame {pairs}; "
            f"max_bin_count {int(r_b.monitors.max_bin_count)}")
    phase_line("13f", "binned3d tracks the 3D oracle with pairs in range", t0)

    # ---- (g) sharded == binned bitwise under LJ ---------------------------
    t0 = time.perf_counter()
    cfg_g = SimConfig(num_parts=N_SHARDED_LJ, force_law="lj", dt=1e-4)
    st_g = init_particles(cfg_g, seed=SEED, method="reference", device=dev)
    r_b = get_engine("binned", cfg_g, device=dev).run(st_g, nsteps=STEPS_SHARDED_LJ)
    eng_g = get_engine("sharded", cfg_g, device=dev, shards=SHARDS)
    r_s = eng_g.run(st_g, nsteps=STEPS_SHARDED_LJ)
    differ = ((r_s.state.pos != r_b.state.pos) | (r_s.state.vel != r_b.state.vel)).any(dim=1)
    if bool(differ.any()) or int(r_s.monitors.migrate_dropped):
        raise AssertionError(f"sharded vs binned (LJ): {int(differ.sum())} of "
                             f"{N_SHARDED_LJ} particles differ (bitwise parity); dropped "
                             f"{int(r_s.monitors.migrate_dropped)}")
    eng_g.check(r_s)
    pairs = frame_distance_stats(r_b.state.pos.cpu().numpy(), cfg_g.cutoff)[2]
    if pairs == 0:
        raise AssertionError("sharded vs binned (LJ): no pair in range at the end")
    log(f"  sharded ({SHARDS} strips) == binned bitwise under LJ (dt 1e-4), "
        f"n={N_SHARDED_LJ}, {STEPS_SHARDED_LJ} steps: {pairs} pairs in range at the "
        f"end; max_bin_count {int(r_s.monitors.max_bin_count)}, deferred "
        f"{int(r_s.monitors.deferred)}")
    phase_line("13g", "sharded == binned bitwise under LJ", t0)
    phase_line("13", "particle-list engines clean", t13)


def phase_repack(kernels, smi: str) -> None:
    """Phase 14: the 3D repulsive config at full width on ``cuda3d``, its
    three arms (``REPACK_ARMS``) from one initial state. Fills the records
    of K3, K4 and K5 on this path (arm (b), the capacity-phase repack)."""
    import torch

    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.harness import timed_run
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda, grid3_step_plain
    from ppsim_tpu_torch.ops.cuda_rebin3 import (
        rebin3_inplane_cuda, rebin3_inplane_plain, rebin3_ypass_cuda,
        rebin3_ypass_plain,
    )

    dev = torch.device("cuda", 0)
    t14 = time.perf_counter()
    cfg = SimConfig(**REPULSIVE3)
    n = cfg.num_parts
    path = [kernels[k] for k in ("grid3_step_repulsive", "rebin3_inplane_repulsive",
                                 "rebin3_ypass_repulsive")]
    ti = time.perf_counter()
    state = init_particles(cfg, seed=SEED, method="fast", device=dev)
    torch.cuda.synchronize()
    log(f"init_particles fast 3D (n={n}, seed={SEED}): {time.perf_counter() - ti:.2f} s")
    arms = {}
    for key, label, over in REPACK_ARMS:
        t0 = time.perf_counter()
        c = cfg.with_(**over)
        engine = get_engine("cuda3d", c, device=dev)
        g = engine.geom
        if (g.ys, g.xs, g.zs, g.capacity, engine.rebin_every) != REPULSIVE3_GEOM:
            raise AssertionError(f"unexpected 3D repulsive geometry {g}")
        for rec in path:
            rec["wrapper"].launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
        launches = [rec["wrapper"].launches for rec in path]
        peak = torch.cuda.max_memory_allocated(dev)
        if min(launches) == 0:
            raise AssertionError(f"arm ({key}): launches {launches}: a kernel of the "
                                 "path did not run")
        engine.check(result)
        check_final(result.carry.slab, result.state.pos, n, 3, cfg.size)
        final_frame_check(f"arm ({key})", result.state.pos, c)
        m = result.monitors
        attempts = getattr(engine, "_last_repack_attempts", None)
        switch = getattr(engine, "_last_repack_switch", None)
        shown = (attempts if attempts is None or len(attempts) <= 6
                 else f"{attempts[:3]} ... {attempts[-2:]} ({len(attempts)})")
        log(f"  arm ({key}) {label}: n={n} 3D repulsive steps={STEPS_MAIN} "
            f"cadence {engine.rebin_every}: {seconds:.4f} s = "
            f"{n * STEPS_MAIN / seconds / 1e6:.2f} M particle-steps/s ({smi})")
        log(f"    packing capacity {engine._pack_capacity}, capacity at the end "
            f"{engine.capacity}, init spill {engine._pack_spill}; repack attempts "
            f"{shown}, switch {switch}")
        log(f"    monitors: max_bin_count {int(m.max_bin_count)} dropped "
            f"{int(m.migrate_dropped)} max_speed {float(m.max_speed):.4f} deferred "
            f"{int(m.deferred)}; every pid 0..{n - 1} in exactly one slot; peak "
            f"device memory {peak} bytes; launches K3 {launches[0]}, K4 "
            f"{launches[1]}, K5 {launches[2]}")
        slab = result.carry.slab
        a3 = (*slab[:6], engine.geom, c.cutoff, c.min_r, c.mass, c.dt, c.size,
              c.force_law, c.law_params)
        k3_ms = late_ms(lambda: grid3_step_cuda(*a3))
        log(f"    K3 on the final slab (capacity {engine.capacity}): {k3_ms:.4f} "
            f"ms/call ({smi})")
        arms[key] = dict(seconds=seconds, capacity=engine.capacity, k3_ms=k3_ms,
                         state=result.state, launches=launches)
        if key == "b":
            final_b = (slab, engine.geom, c)
        del result, slab, a3, engine
        torch.cuda.empty_cache()
        phase_line(f"14{key}", f"3D repulsive arm ({key}) clean", t0)

    # ---- (b) against (a), and the kernels on (b)'s final slab -------------
    t0 = time.perf_counter()
    a, b, c_ = arms["a"], arms["b"], arms["c"]
    if b["capacity"] == a["capacity"]:
        assert_equal("arm (b) pos vs arm (a)", b["state"].pos, a["state"].pos)
        assert_equal("arm (b) vel vs arm (a)", b["state"].vel, a["state"].vel)
        log("  arm (b) never committed a repack: its final state is bitwise equal "
            "to arm (a)'s")
    else:
        log(f"  arm (b) committed a repack: largest difference from arm (a) pos "
            f"{max_abs_diff(b['state'].pos, a['state'].pos):.3e}, vel "
            f"{max_abs_diff(b['state'].vel, a['state'].vel):.3e}")
    log(f"  seconds (a) {a['seconds']:.4f}, (b) {b['seconds']:.4f}, (c) "
        f"{c_['seconds']:.4f}; (a) / (c) = {a['seconds'] / c_['seconds']:.4f}, "
        f"(b) / (c) = {b['seconds'] / c_['seconds']:.4f}; K3 on the final slabs: "
        f"capacity {a['capacity']} {a['k3_ms']:.4f} ms, capacity {c_['capacity']} "
        f"{c_['k3_ms']:.4f} ms ({smi})")
    slab, geom, cfg_b = final_b
    k3, k4, k5 = path
    for rec, n_launch in zip(path, b["launches"]):
        rec["launches"] = n_launch
    k3["max_abs_err"] = k3_compare(f"3D repulsive arm (b) final slab (capacity "
                                   f"{geom.capacity})", slab, geom, cfg_b)
    k45_compare(f"3D repulsive arm (b) final slab (capacity {geom.capacity})", slab,
                geom, cfg_b.evac_capacity)
    k4["max_abs_err"] = k5["max_abs_err"] = 0.0
    evac = cfg_b.evac_capacity
    a3 = (*slab[:6], geom, cfg_b.cutoff, cfg_b.min_r, cfg_b.mass, cfg_b.dt,
          cfg_b.size, cfg_b.force_law, cfg_b.law_params)
    mid, cnt = rebin3_inplane_cuda(slab, geom, evac)
    kern_fns = (lambda: grid3_step_cuda(*a3), lambda: rebin3_inplane_cuda(slab, geom, evac),
                lambda: rebin3_ypass_cuda(mid, cnt, geom, evac))
    plain_fns = (lambda: grid3_step_plain(*a3), lambda: rebin3_inplane_plain(slab, geom, evac),
                 lambda: rebin3_ypass_plain(mid, cnt, geom, evac))
    plane_b = 4 * slab.xl.numel()
    bin_b = plane_b // geom.capacity
    pairs = candidate_pairs(slab.pid)
    for rec, kern, plain, nbytes, flops in zip(
            path, kern_fns, plain_fns,
            (12 * plane_b + bin_b, 14 * plane_b + 5 * bin_b, 14 * plane_b + 4 * bin_b),
            (8 * pairs, 0, 0)):
        p0 = cuda_ms(plain, 1)
        ms = late_ms(kern)
        p1 = cuda_ms(plain, 1)
        bound, by = bound_of(nbytes, flops)
        rec.update(ms=ms, plain_ms=min(p0, p1), bound_ms=bound, bound_by=by)
    k3["ms_by_capacity"] = {str(a["capacity"]): a["k3_ms"], str(c_["capacity"]): c_["k3_ms"]}
    log(f"  on arm (b)'s final slab ({geom.ys}x{geom.xs}x{geom.zs} cap "
        f"{geom.capacity}; ms/call; {smi}): " + "; ".join(
            f"{rec['name']} {rec['ms']:.4f} (plain {rec['plain_ms']:.3f}, bound "
            f"{rec['bound_ms']:.4f} by {rec['bound_by']})" for rec in path)
        + f"; {pairs} candidate pairs")
    del slab, mid, cnt, a3, final_b, arms
    torch.cuda.empty_cache()
    phase_line("14d", "K3, K4, K5 agree with their plain twins on arm (b)'s final slab", t0)
    phase_line("14", "3D repulsive config: three arms clean", t14)


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
    from ppsim_tpu_torch.ops.cuda_grid import (
        grid_force_cuda, grid_step_cuda, grid_step_plain,
    )
    from ppsim_tpu_torch.ops.cuda_rebin import (
        rebin_axes_call_cuda, rebin_axes_call_plain, rebin_counts_cuda, rebin_plan,
        rebin_shuffle_cuda,
    )
    from ppsim_tpu_torch.ops.cuda_grid3 import grid3_step_cuda
    from ppsim_tpu_torch.ops.cuda_rebin3 import rebin3_inplane_cuda, rebin3_ypass_cuda
    from ppsim_tpu_torch.testing import (
        REBIN_EDGE_GEOMETRY, STRESS_GEOMETRY, rebin_edge_slab, stress_slab,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def entry(name, source, replaces, wrapper):
        return {"name": name, "route": "cuda",
                "source": f"ppsim_tpu_torch/csrc/{source}",
                "replaces": f"ppsim_tpu/ops/{replaces}", "library_ms": None,
                "wrapper": wrapper}

    kernels = {
        # K1 also replaces the two-sided _step_kernel_asym: its own design
        "grid_step": entry("grid_step", "grid_step.cu",
                           "pallas_grid.py:340, ppsim_tpu/ops/pallas_grid.py:305",
                           grid_step_cuda),
        "rebin_axes": entry("rebin_axes", "rebin_axes.cu",
                            "pallas_rebin.py:370", rebin_axes_call_cuda),
        "grid3_step": entry("grid3_step", "grid3_step.cu",
                            "pallas_grid3d.py:42", grid3_step_cuda),
        "rebin3_inplane": entry("rebin3_inplane", "rebin3.cu",
                                "pallas_rebin3.py:272", rebin3_inplane_cuda),
        "rebin3_ypass": entry("rebin3_ypass", "rebin3.cu",
                              "pallas_rebin3.py:284", rebin3_ypass_cuda),
        "grid_force": entry("grid_force", "grid_step.cu", "pallas_grid.py:184",
                            grid_force_cuda),
        "rebin_counts": entry("rebin_counts", "rebin_dirs9.cu",
                              "pallas_rebin.py:99", rebin_counts_cuda),
        "rebin_shuffle": entry("rebin_shuffle", "rebin_dirs9.cu",
                               "pallas_rebin.py:119", rebin_shuffle_cuda),
        # the shard forms (row offset + ghost rows) of the same kernels
        "grid_step_shard": entry("grid_step_shard", "grid_step.cu",
                                 "pallas_grid.py:524", grid_step_cuda),
        "rebin_axes_shard": entry("rebin_axes_shard", "rebin_axes.cu",
                                  "pallas_rebin.py:604", rebin_axes_call_cuda),
        "rebin_counts_shard": entry("rebin_counts_shard", "rebin_dirs9.cu",
                                    "pallas_rebin.py:242", rebin_counts_cuda),
        "rebin_shuffle_shard": entry("rebin_shuffle_shard", "rebin_dirs9.cu",
                                     "pallas_rebin.py:267", rebin_shuffle_cuda),
        # the 3D shard forms (y offset + ghost y slabs)
        "grid3_step_shard": entry("grid3_step_shard", "grid3_step.cu",
                                  "pallas_grid3d.py:275", grid3_step_cuda),
        "rebin3_inplane_shard": entry("rebin3_inplane_shard", "rebin3.cu",
                                      "pallas_rebin3.py:388", rebin3_inplane_cuda),
        "rebin3_ypass_shard": entry("rebin3_ypass_shard", "rebin3.cu",
                                    "pallas_rebin3.py:466", rebin3_ypass_cuda),
        # the tile forms (row and column offsets + ghost rows and columns)
        "grid_step_tile": entry("grid_step_tile", "grid_step.cu",
                                "pallas_grid.py:583", grid_step_cuda),
        "rebin_axes_tile": entry("rebin_axes_tile", "rebin_axes.cu",
                                 "pallas_rebin.py:646", rebin_axes_call_cuda),
        # phase 14's path: the 3D kernels on the 3D repulsive config with the
        # capacity-phase repack
        "grid3_step_repulsive": entry("grid3_step_repulsive", "grid3_step.cu",
                                      "pallas_grid3d.py:42", grid3_step_cuda),
        "rebin3_inplane_repulsive": entry("rebin3_inplane_repulsive", "rebin3.cu",
                                          "pallas_rebin3.py:272", rebin3_inplane_cuda),
        "rebin3_ypass_repulsive": entry("rebin3_ypass_repulsive", "rebin3.cu",
                                        "pallas_rebin3.py:284", rebin3_ypass_cuda),
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
    ge = REBIN_EDGE_GEOMETRY
    k2_compare("strip-edge slab", rebin_edge_slab(ge, rebin_plan(ge.shape), 0, dev),
               ge, 2)
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
    # bounds on this slab: K1 reads 4 planes and writes 4 + the speed plane,
    # and makes at least 5 flops (2 sub, 2 mul, 1 add) per candidate pair;
    # K2 reads 5 planes and writes 5 + 4 count planes
    plane_b = 4 * slab11.xl.numel()
    pairs2 = candidate_pairs(slab11.pid)
    b1, by1 = bound_of(8 * plane_b + plane_b // geom.capacity, 5 * pairs2)
    b2, by2 = bound_of(10 * plane_b + 4 * plane_b // geom.capacity, 0)
    kernels["grid_step"].update(bound_ms=b1, bound_by=by1)
    kernels["rebin_axes"].update(bound_ms=b2, bound_by=by2)
    log(f"  bounds: K1 {b1:.4f} ms ({by1}; {pairs2} candidate pairs), "
        f"K2 {b2:.4f} ms ({by2})")
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
    run_cli("CLI", ["-n", "262144", "-s", str(SEED), "--steps", "200",
                    "--engine", "cuda", "--check"])
    phase_line("2", "CLI --check PASS", t0)

    # ---- phase 3: the main path at full width ----------------------------
    t0 = time.perf_counter()
    engine = get_engine("cuda", cfg, device=dev)
    path3 = [kernels[k] for k in ("grid_step", "rebin_axes")]
    for k in path3:
        k["wrapper"].launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    result, seconds = timed_run(engine, state, STEPS_MAIN, 0)
    for k in path3:
        k["launches"] = k["wrapper"].launches
    engine.check(result)
    check_final(result.carry.slab, result.state.pos, N_MAIN, 2, cfg.size)
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
    log(f"  peak device memory: {torch.cuda.max_memory_allocated(dev)} bytes "
        f"({smi})")
    log(f"  launches: grid_step {k_step['launches']} (schedule {STEPS_MAIN} "
        f"+ {warm} warm-up), rebin_axes {k_rebin['launches']} (schedule "
        f"{STEPS_MAIN // CADENCE_MAIN} + 1 warm-up)")
    log(f"  every pid 0..{N_MAIN - 1} in exactly one slot")
    # K1 on the final slab: the late-run state, rebinned 91 times
    slab_f = result.carry.slab
    k_step["max_abs_err"] = max(k_step["max_abs_err"], k1_compare(
        f"final slab ({STEPS_MAIN} steps)", slab_f, geom, cfg))
    a1f = (slab_f.xl, slab_f.yl, slab_f.vx, slab_f.vy, geom, cfg.cutoff,
           cfg.min_r, cfg.mass, cfg.dt, cfg.size)
    k_step["ms_late"] = late_ms(lambda: grid_step_cuda(*a1f))
    log(f"  K1 on the final slab: {k_step['ms_late']:.4f} ms/call (step-11 "
        f"slab {k_step['ms']:.4f}; {smi})")
    k2_compare(f"final slab ({STEPS_MAIN} steps)", slab_f, geom, cfg.evac_capacity)
    k_rebin["ms_late"] = late_ms(
        lambda: rebin_axes_call_cuda(slab_f, geom, cfg.evac_capacity))
    log(f"  K2 on the final slab: {k_rebin['ms_late']:.4f} ms/call (step-11 "
        f"slab {k_rebin['ms']:.4f}; bound there {k_rebin['bound_ms']:.4f}; {smi})")
    del slab_f, a1f
    phase_line("3", "full-width main path clean", t0)

    ref3 = (result.state, seconds)
    del result, engine
    torch.cuda.empty_cache()
    state3, ref6 = phase_3d(kernels, state, cfg, smi)
    torch.cuda.empty_cache()
    phase_2d_rest(kernels, state, cfg, seconds, smi)
    torch.cuda.empty_cache()
    ref9 = phase_sharded(kernels, state, cfg, ref3, smi)
    torch.cuda.empty_cache()
    phase_sharded3d(kernels, state3, ref6, smi)
    torch.cuda.empty_cache()
    phase_tile(kernels, state, cfg, ref3, ref9, smi)
    torch.cuda.empty_cache()
    phase_particle(state, ref3, state3, smi)
    del state, state3, ref3, ref6, ref9
    torch.cuda.empty_cache()
    phase_repack(kernels, smi)

    out = [{k: v for k, v in rec.items() if k != "wrapper"}
           for rec in kernels.values()]
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
