"""Fused slab-grid step: the Hopper kernel K1 and its plain twin (port of
:mod:`ppsim_tpu.ops.pallas_grid`, ``grid_step_pallas``).

:func:`grid_step_cuda` launches ``csrc/grid_step.cu`` (force, Verlet move,
wall fold and the per-bin max|v|^2 plane in one pass) on CUDA tensors and
runs :func:`grid_step_plain` on CPU tensors; a tensor on any other device
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build
from ppsim_tpu_torch.ops.binning import BIG
from ppsim_tpu_torch.ops.grid_ops import SlabGeometry, f32, grid_force_xla, move_planes

__all__ = ["grid_step_cuda", "grid_step_plain", "MAX_CAP"]

# Largest slot capacity the kernel is instantiated for (csrc/grid_step.cu).
MAX_CAP = 32


def grid_step_plain(xl, yl, vx, vy, geom: SlabGeometry, cutoff, min_r, mass,
                    dt, size):
    """Plain twin of K1: ``grid_force_xla`` + the move, returning
    ``(xl', yl', vx', vy', speed2)`` with ``speed2`` the (R, C) plane of
    per-bin max |v|^2. Like the kernel (and the TPU kernel), slot aliveness
    comes from the position sentinel: dead slots hold exactly BIG."""
    ax, ay = grid_force_xla(xl, yl, geom, cutoff, min_r, mass)
    xl, yl, vx, vy, speed2 = move_planes(xl, yl, vx, vy, ax, ay,
                                         xl < 0.5 * BIG, geom, dt, size)
    return xl, yl, vx, vy, speed2.amax(dim=0)


def _check_planes(planes, geom: SlabGeometry, dtype=torch.float32) -> None:
    for t in planes:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != geom.shape:
            raise ValueError(f"expected shape {geom.shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous slab planes")
        if t.device != planes[0].device:
            raise ValueError("slab planes on different devices")


def grid_step_cuda(xl, yl, vx, vy, geom: SlabGeometry, cutoff, min_r, mass,
                   dt, size):
    """Fused step, same contract as :func:`grid_step_plain`. CUDA tensors
    launch K1 (``grid_step_cuda.launches`` counts the launches); CPU tensors
    run the plain twin."""
    if xl.device.type == "cpu":
        return grid_step_plain(xl, yl, vx, vy, geom, cutoff, min_r, mass, dt, size)
    _check_planes((xl, yl, vx, vy), geom)
    cap, R, C = geom.shape
    if cap > MAX_CAP:
        raise ValueError(f"capacity {cap} > {MAX_CAP}, the kernel's largest")
    outs = [torch.empty_like(xl) for _ in range(4)]
    speed2 = torch.empty((R, C), dtype=torch.float32, device=xl.device)
    lib = _build.kernels()
    err = lib.ppsim_grid_step(
        *(t.data_ptr() for t in (xl, yl, vx, vy, *outs, speed2)),
        xl.device.index, cap, R, C,
        f32(geom.bin_size), f32(cutoff * cutoff), f32(cutoff),
        f32(min_r * min_r), f32(1.0 / mass), f32(dt), f32(size),
        torch.cuda.current_stream(xl.device).cuda_stream)
    _build.check_launch(err, "grid_step kernel")
    grid_step_cuda.launches += 1
    return (*outs, speed2)


grid_step_cuda.launches = 0
