"""Measured roofline of the card and of the step kernel (port of
``bench/mfu.py``).

Quoting datasheet peaks places a kernel against a card that may run below
them (a lower power limit, a lower clock). This module measures what the
card at hand reaches, then places the step kernel against it. Three
measurements, one process:

1. **float32 FMA peak** (:func:`vpu_peak_flops`): the ``fma_chain`` kernel
   (``csrc/roofline.cu``), ``chains`` independent FFMA chains an element
   held in registers, the pair loop's op mix. At the defaults every value
   overflows to inf within the first call (b ~1.5, 1.5^256 > 3.4e38), as in
   the TPU probe; an FFMA on inf costs what it costs on a finite value, so
   the rate holds.
2. **Device-memory stream rate** (:func:`hbm_stream_bw`): the
   ``stream_add`` kernel, ``y = x + 1`` over 1 GiB (read + write), 16-byte
   loads and stores.
3. **The step kernel itself** (:func:`step_kernel_numbers`): the marginal
   per-step seconds of the ``cuda`` engine by variant subtraction
   (:func:`ppsim_tpu_torch.profiling.phase_times`), turned into lane-pairs/s
   and FLOP/s by the JAX layout's static count: every bin's full slot
   planes against its own (the triangle) and four neighbours, 18 flop a
   pair. That count is read from the geometry, so it is the same work
   whatever implements it; K1 compacts live slots and computes each pair
   where it is owned, so it executes far fewer FLOPs than the count says:
   ``kernel_tflops`` is a rate of work as the TPU kernel defines it, not
   K1's executed FLOP/s.

Each probe times ``calls`` chained launches, ping-ponging two buffers, with
CUDA events (the host clock on the CPU): the best of 5 after one untimed
run. Prints one JSON line with ``bench/mfu.py``'s keys, plus the card's
power limit (``nvidia-smi``) beside its name.

Usage:  python -m ppsim_tpu_torch.roofline [-n 20971520] [--skip-step]
        [--device cuda]

It runs on the card unless ``--device cpu`` is given (there the kernels'
plain twins run, and the numbers are the CPU's); ``cuda`` without a GPU
raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ppsim_tpu_torch.engines.base import resolve_device
from ppsim_tpu_torch.ops.cuda_roofline import fma_chain_cuda, stream_add_cuda

__all__ = ["vpu_peak_flops", "hbm_stream_bw", "step_kernel_numbers", "card_line", "main"]


def _best(fn, device, reps: int = 5) -> float:
    """Least seconds of ``reps`` runs of ``fn()``: CUDA events around each
    run on the card, the host clock on the CPU."""
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def _chained(kernel, x, calls: int):
    """A run of ``calls`` launches of ``kernel(y, out=...)`` from ``x``, each
    output the next input, in two buffers taken in turn."""
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def run():
        y = x
        for i in range(calls):
            y = kernel(y, out=bufs[i % 2])
        return y

    return run


# --------------------------------------------------------------- FMA peak
def vpu_peak_flops(iters: int = 256, rows: int = 4096, cols: int = 1024,
                   calls: int = 48, chains: int = 8, device="cuda") -> float:
    """Peak float32 FLOP/s: ``chains`` independent FMA chains of ``iters``
    steps on every element of a (rows, cols) block, ``calls`` chained
    launches a run."""
    dev = resolve_device(device)
    x = torch.full((rows, cols), 0.999, dtype=torch.float32, device=dev)
    run = _chained(lambda y, out: fma_chain_cuda(y, iters, chains, out=out), x, calls)
    run()  # untimed: builds the kernels on first use
    t = _best(run, dev)
    return rows * cols * iters * chains * 2 * calls / t


# ------------------------------------------------------- stream bandwidth
def hbm_stream_bw(mb: int = 1024, calls: int = 16, device="cuda") -> float:
    """Streaming bytes/s of ``y = x + 1`` over ``mb`` MiB (read + write),
    ``calls`` chained launches a run."""
    dev = resolve_device(device)
    n = mb * 1024 * 1024 // 4
    x = torch.ones((n // 2048, 2048), dtype=torch.float32, device=dev)
    run = _chained(stream_add_cuda, x, calls)
    run()
    t = _best(run, dev)
    return calls * 2 * n * 4 / t


# ------------------------------------------------------------- step kernel
def step_kernel_numbers(n: int, device="cuda"):
    """The ``cuda`` engine's per-phase step times at ``n`` particles (seed
    42, the fast init) and the JAX layout's static work per step."""
    from ppsim_tpu_torch.config import SimConfig
    from ppsim_tpu_torch.engines import get_engine
    from ppsim_tpu_torch.initlib import init_particles
    from ppsim_tpu_torch.ops.grid_ops import SlabGeometry
    from ppsim_tpu_torch.profiling import phase_times

    device = resolve_device(device)
    cfg = SimConfig(num_parts=n)
    geom = SlabGeometry.for_config(cfg)
    state = init_particles(cfg, seed=42, method="fast", device=device)
    eng = get_engine("cuda", cfg, device=device)
    times = phase_times(eng, state, steps=40)

    cap = geom.capacity
    bins = geom.rows_pad * geom.cols_pad
    # Symmetric kernel: triangle cap(cap-1)/2 + 4 full directions cap^2
    pair_planes = cap * (cap - 1) // 2 + 4 * cap * cap
    pairs_per_step = bins * pair_planes
    # Hot pair body (repulsive law): dx,dy (2) r2 (3) max (1) rsqrt (~1)
    # u (2) coef (2) where (1) fx,fy (2) four accumulator adds (4) = ~18
    flops_per_pair = 18
    occupancy = n / bins
    return {
        "phase_ms": {k: round(v * 1e3, 3) for k, v in times.items()},
        "grid": {"rows": geom.rows_pad, "cols": geom.cols_pad,
                 "capacity": cap, "mean_occupancy": round(occupancy, 2)},
        "pair_planes_per_bin": pair_planes,
        "pairs_per_step": pairs_per_step,
        "useful_pair_fraction": round(
            # alive x alive pairs among evaluated slab-pair lanes
            (occupancy / cap) ** 2, 3),
        "kernel_flops_per_step": pairs_per_step * flops_per_pair,
        "force_move_s": times["force+move"],
        "step_s": times["step"],
    }


def card_line(device) -> str | None:
    """``nvidia-smi``'s "name, power limit" of the card behind ``device``
    (None on the CPU, or where nvidia-smi is missing)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except FileNotFoundError:
        return None
    lines = out.strip().splitlines()
    return lines[min(device.index, len(lines) - 1)].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ppsim_tpu_torch.roofline")
    ap.add_argument("-n", type=int, default=20_971_520)
    ap.add_argument("--skip-step", action="store_true",
                    help="only measure the device peaks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = card_line(dev)
    out = {
        "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "power_limit": None if card is None else card.rsplit(",", 1)[-1].strip(),
        "vpu_f32_peak_tflops": round(vpu_peak_flops(device=dev) / 1e12, 3),
        "hbm_stream_gbps": round(hbm_stream_bw(device=dev) / 1e9, 1),
    }
    if not args.skip_step:
        k = step_kernel_numbers(args.n, device=dev)
        out.update(k)
        out["kernel_tflops"] = round(
            k["kernel_flops_per_step"] / k["force_move_s"] / 1e12, 3)
        out["vpu_utilization"] = round(
            out["kernel_tflops"] / out["vpu_f32_peak_tflops"], 3)
        out["pair_interactions_per_sec"] = round(
            k["pairs_per_step"] / k["force_move_s"] / 1e9, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
