"""Trajectory correctness checker: absmin / absavg interacting-pair distances
(port of :mod:`ppsim_tpu.checker`, 2D and 3D).

For each saved frame, collect the distances of all pairs closer than
``cutoff``. ``absmin`` is the minimum over frames, ``absavg`` the mean. A
correct repulsive run keeps absmin above ``0.4 * cutoff`` and absavg above
``0.8 * cutoff`` (the CS267 hw2 bands the reference was graded against). The
checker is numpy on the host and shares nothing with the engines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ppsim_tpu_torch.config import SimConfig

__all__ = ["CheckResult", "frame_distance_stats", "check_frames", "check_trajectory"]

ABSMIN_BAND = 0.4
ABSAVG_BAND = 0.8


class CheckResult(NamedTuple):
    absmin: float  # min interacting-pair distance across all frames
    absavg: float  # mean interacting-pair distance across all frames
    passed: bool
    cutoff: float
    oob: int = 0  # positions outside the box (explosion/corruption signature)

    def __str__(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        extra = f", oob={self.oob}" if self.oob else ""
        return (
            f"{status}: absmin={self.absmin:.6g} ({self.absmin / self.cutoff:.2f} cutoff, "
            f"band >{ABSMIN_BAND}), absavg={self.absavg:.6g} "
            f"({self.absavg / self.cutoff:.2f} cutoff, band >{ABSAVG_BAND}){extra}"
        )


def frame_distance_stats(pos, cutoff: float, cell_block: int = 4096,
                         use_native: bool = True):
    """(min, sum, count) of pair distances below cutoff in one frame.

    Small frames use the brute-force O(N^2) pass (the trust anchor); frames
    above 20,000 particles use the native cell-list pass, or the numpy
    cell-list pass of their dimension when the native library cannot be
    built.
    """
    pos = np.asarray(pos, dtype=np.float64)
    n, dim = pos.shape
    if n > 20_000:
        if use_native:
            from ppsim_tpu_torch.native import native_frame_stats

            stats = native_frame_stats(pos, cutoff)
            if stats is not None:
                return stats
        if dim == 2:
            return _cell_list_stats(pos, cutoff)
        return _cell_list_stats3(pos, cutoff)
    dmin = np.inf
    dsum = 0.0
    dcount = 0
    for start in range(0, n, cell_block):
        block = pos[start : start + cell_block]
        d = block[:, None, :] - pos[None, :, :]
        d2 = (d * d).sum(axis=-1)
        ii = np.arange(start, start + block.shape[0])
        d2[np.arange(block.shape[0]), ii] = np.inf  # mask self-pairs
        hit = d2 < cutoff * cutoff
        if hit.any():
            d = np.sqrt(d2[hit])
            dmin = min(dmin, float(d.min()))
            dsum += float(d.sum())
            dcount += int(d.size)
    return dmin, dsum, dcount


def _cell_list_stats(pos: np.ndarray, cutoff: float):
    """2D cell-list pair stats in vectorized numpy: particles sorted into
    cutoff-sized cells, the 9 stencil offsets matched as padded cell slabs."""
    n = pos.shape[0]
    side = max(pos.max(), 1e-9)
    ncell = max(1, int(np.ceil(side / cutoff)))
    cx = np.clip((pos[:, 0] / cutoff).astype(np.int64), 0, ncell - 1)
    cy = np.clip((pos[:, 1] / cutoff).astype(np.int64), 0, ncell - 1)
    cid = cx * ncell + cy
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    spos = pos[order]
    starts = np.searchsorted(sorted_cid, np.arange(ncell * ncell))
    ends = np.searchsorted(sorted_cid, np.arange(ncell * ncell), side="right")
    cap = int((ends - starts).max())
    slot = np.arange(n) - starts[sorted_cid]
    table = np.full((ncell * ncell, cap), -1, dtype=np.int64)
    table[sorted_cid, slot] = np.arange(n)
    valid = table >= 0
    grid_valid = valid.reshape(ncell, ncell, cap)
    grid_px = np.where(valid, spos[table.clip(0), 0], 1e9).reshape(ncell, ncell, cap)
    grid_py = np.where(valid, spos[table.clip(0), 1], 1e9).reshape(ncell, ncell, cap)

    dmin = np.inf
    dsum = 0.0
    dcount = 0
    # Row bands bound the (cells, cap, cap) pair temporaries to tens of MB.
    band = max(1, int(4e6 // max(1, ncell * cap * cap)))
    for r0 in range(0, ncell, band):
        r1 = min(ncell, r0 + band)
        sx = grid_px[r0:r1]
        sy = grid_py[r0:r1]
        nrows = r1 - r0
        for dx_ in (-1, 0, 1):
            sr0, sr1 = r0 + dx_, r1 + dx_
            nx = np.full((nrows, ncell, cap), 1e9)
            ny = np.full((nrows, ncell, cap), 1e9)
            vs0, vs1 = max(sr0, 0), min(sr1, ncell)
            if vs0 < vs1:
                nx[vs0 - sr0 : vs1 - sr0] = grid_px[vs0:vs1]
                ny[vs0 - sr0 : vs1 - sr0] = grid_py[vs0:vs1]
            for dy_ in (-1, 0, 1):
                mx = np.full_like(nx, 1e9)
                my = np.full_like(ny, 1e9)
                ys = slice(max(0, -dy_), ncell - max(0, dy_))
                yd = slice(max(0, dy_), ncell - max(0, -dy_))
                mx[:, yd] = nx[:, ys]
                my[:, yd] = ny[:, ys]
                ddx = mx[:, :, None, :] - sx[:, :, :, None]
                ddy = my[:, :, None, :] - sy[:, :, :, None]
                d2 = ddx * ddx + ddy * ddy
                # d2 == 0 off the slot diagonal of the same cell is two exactly
                # coincident particles (a duplication bug): count it as a
                # distance-0 pair, as the brute-force pass would.
                if dx_ == 0 and dy_ == 0:
                    vv = grid_valid[r0:r1]
                    pair_valid = vv[:, :, None, :] & vv[:, :, :, None]
                    ndup = int(((d2 == 0.0) & pair_valid
                                & ~np.eye(cap, dtype=bool)).sum())
                    if ndup:
                        dmin = 0.0
                        dcount += ndup
                hit = (d2 < cutoff * cutoff) & (d2 > 0.0)
                if hit.any():
                    d = np.sqrt(d2[hit])
                    dmin = min(dmin, float(d.min()))
                    dsum += float(d.sum())
                    dcount += int(d.size)
    return dmin, dsum, dcount


def _cell_list_stats3(pos: np.ndarray, cutoff: float):
    """3D cell-list pair stats in numpy: sorted cell ids and a searchsorted
    walk over the same-cell triangle and the 13 lexicographically positive
    neighbour offsets, each unordered pair once (absmin/absavg equal the
    brute-force pass's, which counts each pair twice). No dense tables: at
    the 3D stretch density a cutoff cell holds ~0.14 particles on average."""
    n = pos.shape[0]
    side = max(pos.max(), 1e-9)
    ncell = max(1, int(np.ceil(side / cutoff)))
    c = np.clip((pos / cutoff).astype(np.int64), 0, ncell - 1)
    cid = (c[:, 1] * ncell + c[:, 0]) * ncell + c[:, 2]
    order = np.argsort(cid, kind="stable")
    spos = pos[order]
    scid = cid[order]
    cy, cx, cz = c[order, 1], c[order, 0], c[order, 2]

    dmin = np.inf
    dsum = 0.0
    dcount = 0
    offsets = [(0, 0, 0)] + [
        (dy, dx, dz)
        for dy in (0, 1) for dx in (-1, 0, 1) for dz in (-1, 0, 1)
        if (dy, dx, dz) > (0, 0, 0)
    ]
    for dy, dx, dz in offsets:
        valid = np.ones(n, dtype=bool)
        if dy:
            valid &= cy + dy < ncell
        if dx:
            valid &= (cx + dx >= 0) & (cx + dx < ncell)
        if dz:
            valid &= (cz + dz >= 0) & (cz + dz < ncell)
        target = scid + (dy * ncell + dx) * ncell + dz
        s = np.searchsorted(scid, target, side="left")
        e = np.searchsorted(scid, target, side="right")
        if (dy, dx, dz) == (0, 0, 0):
            s = np.arange(n) + 1  # same cell: partners after me only
        count = np.where(valid, np.maximum(e - s, 0), 0)
        for j in range(int(count.max()) if n else 0):
            m = j < count
            d = spos[s[m] + j] - spos[m]
            d2 = (d * d).sum(axis=-1)
            hit = d2 < cutoff * cutoff
            if hit.any():
                dh = np.sqrt(d2[hit])
                dmin = min(dmin, float(dh.min()))
                dsum += float(dh.sum())
                dcount += int(dh.size)
    return dmin, dsum, dcount


def check_frames(frames, config: SimConfig) -> CheckResult:
    cutoff = config.cutoff
    absmin = np.inf
    total = 0.0
    count = 0
    oob = 0
    # Wall reflection keeps every position in [0, size]; anything outside is
    # corruption (an exploded run also empties the interacting-pair set).
    lo, hi = -1e-9, config.size + 1e-9
    for frame in frames:
        f = np.asarray(frame)
        oob += int(((f < lo) | (f > hi)).sum())
        m, s, c = frame_distance_stats(f, cutoff)
        absmin = min(absmin, m)
        total += s
        count += c
    absavg = total / count if count else np.inf
    passed = absmin > ABSMIN_BAND * cutoff and absavg > ABSAVG_BAND * cutoff
    # At the reference density a run of >= 1000 particles with no
    # interacting pair at all blew apart.
    if count == 0 and config.num_parts >= 1000:
        passed = False
    if oob:
        passed = False
    return CheckResult(float(absmin), float(absavg), bool(passed), cutoff, oob)


def check_trajectory(path: str, config: SimConfig) -> CheckResult:
    from ppsim_tpu_torch.io import read_trajectory

    frames, size = read_trajectory(path)
    if abs(size - config.size) > 1e-3 * max(1.0, config.size):
        raise ValueError(f"trajectory box size {size} != config size {config.size}")
    return check_frames(frames, config)
