"""Trajectory save format, full-state checkpoints and metrics (port of
:mod:`ppsim_tpu.io`).

The save format is byte-compatible with the reference's ``save()``
(part1/main.cpp:15-28): a header line ``"<n> <size>"``, then one ``"<x> <y>"``
line per particle per frame and a blank line after each frame, numbers in C++
``ostream`` default formatting (6 significant digits).
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import numpy as np
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState, make_state

__all__ = [
    "write_trajectory",
    "append_frame",
    "read_trajectory",
    "save_checkpoint",
    "load_checkpoint",
    "MetricsWriter",
]


def _fmt(v: float) -> str:
    # C++ ostream default: 6 significant digits, shortest form.
    return f"{v:.6g}"


def append_frame(f: IO[str], pos) -> None:
    lines = [
        " ".join(_fmt(v) for v in row)
        for row in np.asarray(pos, dtype=np.float64)
    ]
    f.write("\n".join(lines))
    f.write("\n\n")


def write_trajectory(path: str, frames, size: float) -> None:
    """Write saved frames (F, N, D) in the reference text format."""
    frames = np.asarray(frames)
    with open(path, "w") as f:
        f.write(f"{frames.shape[1]} {_fmt(size)}\n")
        for frame in frames:
            append_frame(f, frame)


def read_trajectory(path: str):
    """Parse the reference text format -> (frames (F, N, D), size)."""
    with open(path) as f:
        header = f.readline().split()
        num_parts, size = int(header[0]), float(header[1])
        flat = [tuple(float(v) for v in line.split())
                for line in f if line.strip()]
    arr = np.asarray(flat, dtype=np.float64)
    if arr.shape[0] % num_parts:
        raise ValueError(
            f"trajectory length {arr.shape[0]} not a multiple of n={num_parts}"
        )
    return arr.reshape(-1, num_parts, arr.shape[1]), size


def save_checkpoint(path: str, state: ParticleState, step: int, config: SimConfig) -> None:
    """Full (pos, vel, step) state as ``.npz`` (the JAX package's layout)."""
    pos, vel = state.to_numpy()
    np.savez(
        path,
        pos=pos,
        vel=vel,
        step=np.int64(step),
        config=json.dumps(
            {
                "num_parts": config.num_parts,
                "density": config.density,
                "cutoff": config.cutoff,
                "mass": config.mass,
                "dt": config.dt,
                "dtype": config.dtype,
            }
        ),
    )


def load_checkpoint(path: str, device="cpu"):
    """Returns (state, step, config_dict)."""
    with np.load(path, allow_pickle=False) as z:
        cfg = json.loads(str(z["config"]))
        dtype = getattr(torch, cfg.get("dtype", "float32"))
        state = make_state(z["pos"], z["vel"], dtype=dtype, device=device)
        return state, int(z["step"]), cfg


class MetricsWriter:
    """JSON-lines metrics emitter (the structured analog of the reference's
    stdout summary line, part1/main.cpp:147)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path

    def emit(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
