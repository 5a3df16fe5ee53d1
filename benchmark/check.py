"""How ``correct`` is decided: the program's outputs against the reference.

The simulation is chaotic: two correct float32 runs of the same start part
within a few hundred steps (the pair forces amplify a rounding each time
two particles meet), so no reference can say where a particle is after
1000 steps. The reference therefore checks the program where a trajectory
is still determined, and follows it back from its own final state:

- ``start_gap``: the reference runs forward from the seeded initial state
  and meets every frame the program saved at a step up to
  :data:`FORWARD_REACH`; the widest gap of a coordinate. This holds the
  pack, the first steps (the first rebin too when a frame lies past it)
  and the frame gather to the reference.
- ``end_gap``: the reference steps back from the program's final state
  (positions and velocities) to the step of its last frame and meets that
  frame; the widest gap of a coordinate. This holds the last steps, at the
  end of a full run (forces of particles in contact, rebins, walls), and
  the final gather to the reference: a wrong force, a particle left
  unmoved or moved twice, or a wrong velocity leaves a gap.
- ``end_bulk_gap``: the gap that all particles but a share
  :data:`BULK_SHARE` stay within, of the same comparison. The widest gap
  swings from seed to seed: a float32 program reflects a particle that
  its rounding puts on the wall one step late, and a contact at the wall
  turns that into a gap of up to a few 1e-3 (2D). This number is steady,
  and holds a fault that touches many particles to a tight limit.
- ``bad_rows``: rows of the final state and of every frame that are not
  finite, lie outside the box, or are all zero (the gather leaves the row
  of an id that no slot holds at 0): a particle lost or an answer broken.
  Its limit is 0.

The frames between are structurally checked only: nothing fixes a
trajectory there but the program's own state, which it does not save.
The reference runs in float64; :func:`control` puts the reference in the
program's place in a lower precision, which has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from benchmark import reference
from benchmark.reference import Physics

__all__ = ["FORWARD_REACH", "BULK_SHARE", "frame_steps", "compare", "verdict",
           "control", "check_lines"]

#: Frames at steps up to this one are met by the forward reference.
FORWARD_REACH = 11
#: Share of the particles whose end gap ``end_bulk_gap`` leaves out.
BULK_SHARE = 1e-5
#: Frames moved to the device at once for the structural count.
_FRAME_BLOCK = 4


def frame_steps(nsteps: int, savefreq: int) -> List[int]:
    """The steps after which a run saves a frame (the reference cadence:
    after step ``i`` with ``(i - 1) % savefreq == 0``)."""
    if savefreq <= 0:
        return []
    return list(range(1, nsteps + 1, savefreq))


def _bad_rows(x: torch.Tensor, size: float) -> int:
    """Rows that are not finite, lie outside ``[0, size]`` (with a float32
    rounding of the box side), or are all zero."""
    x = x.to(torch.float64)
    slack = size * 1e-6
    bad = ~torch.isfinite(x).all(1)
    bad |= ((x < -slack) | (x > size + slack)).any(1)
    bad |= (x == 0).all(1)
    return int(bad.sum())


def _gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row, the widest coordinate gap (NaN where either holds one)."""
    return (a.to(torch.float64) - b.to(torch.float64)).abs().amax(1)


def _widest(g: torch.Tensor) -> float:
    return float("nan") if torch.isnan(g).any() else float(g.max())


def _bulk(g: torch.Tensor) -> float:
    """The gap all rows but a share BULK_SHARE stay within."""
    if torch.isnan(g).any():
        return float("nan")
    k = len(g) - math.ceil(len(g) * BULK_SHARE)
    return float(g.kthvalue(max(k, 1)).values)


def _on(x, device) -> torch.Tensor:
    return (torch.from_numpy(x) if not torch.is_tensor(x) else x).to(device)


def compare(phys: Physics, init_pos, init_vel, frames: Optional[Sequence],
            steps: Sequence[int], final_pos, final_vel, nsteps: int, device,
            dtype=torch.float64) -> Dict[str, float]:
    """The numbers compared for one simulation. ``frames[k]`` is the
    ``(n, ndim)`` frame after step ``steps[k]`` (numpy or tensor);
    ``init_*`` the seeded state it started from; ``final_*`` its final
    state after ``nsteps``."""
    steps = list(steps)
    if frames is None or not steps:
        raise ValueError("the checked simulation saved no frame")
    out = {}
    bad = _bad_rows(_on(final_pos, device), phys.size)
    bad += int((~torch.isfinite(_on(final_vel, device))).any(1).sum())
    for k in range(0, len(steps), _FRAME_BLOCK):
        block = [_on(frames[j], device) for j in range(k, min(k + _FRAME_BLOCK, len(steps)))]
        bad += sum(_bad_rows(f, phys.size) for f in block)
    out["bad_rows"] = float(bad)

    early = [k for k, s in enumerate(steps) if s <= FORWARD_REACH]
    if early:
        pos, vel = _on(init_pos, device).to(dtype), _on(init_vel, device).to(dtype)
        at, gap = 0, 0.0
        for k in early:
            while at < steps[k]:
                pos, vel = reference.forward_step(pos, vel, phys)
                at += 1
            gap = max(gap, _widest(_gaps(pos, _on(frames[k], device))))
        out["start_gap"] = gap

    last = len(steps) - 1
    if steps[last] < nsteps and steps[last] > FORWARD_REACH:
        pos, vel = _on(final_pos, device).to(dtype), _on(final_vel, device).to(dtype)
        for _ in range(nsteps - steps[last]):
            pos, vel = reference.reverse_step(pos, vel, phys)
        g = _gaps(pos, _on(frames[last], device))
        out["end_gap"] = _widest(g)
        out["end_bulk_gap"] = _bulk(g)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True iff every number compared is at most its limit, and the start
    and the end were compared (a NaN fails)."""
    need = ("bad_rows", "start_gap", "end_gap", "end_bulk_gap")
    return (all(k in numbers for k in need)
            and all(numbers[k] <= limits[k] for k in numbers))


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in numbers]


def control(phys: Physics, init_pos, init_vel, steps: Sequence[int],
            final_pos, final_vel, nsteps: int, device,
            low=torch.bfloat16) -> Dict[str, float]:
    """The numbers of the control: the reference in ``low`` put in the
    program's place. Its early frames come from its own run forward from
    the seeded state. Its last frame and final state come from the state
    at the last frame's step that the float64 reference finds stepping
    back from the program's final state (the program's trajectory), which
    the control rounds to ``low`` and steps forward to ``nsteps``."""
    steps = list(steps)
    frames, fsteps = [], []
    pos, vel = _on(init_pos, device).to(low), _on(init_vel, device).to(low)
    at = 0
    for s in steps:
        if s > FORWARD_REACH:
            break
        while at < s:
            pos, vel = reference.forward_step(pos, vel, phys)
            at += 1
        frames.append(pos.clone())
        fsteps.append(s)
    last = steps[-1]
    pos = _on(final_pos, device).to(torch.float64)
    vel = _on(final_vel, device).to(torch.float64)
    for _ in range(nsteps - last):
        pos, vel = reference.reverse_step(pos, vel, phys)
    pos, vel = pos.to(low), vel.to(low)
    frames.append(pos.clone())
    fsteps.append(last)
    for _ in range(nsteps - last):
        pos, vel = reference.forward_step(pos, vel, phys)
    return compare(phys, init_pos, init_vel, frames, fsteps, pos, vel,
                   nsteps, device)
