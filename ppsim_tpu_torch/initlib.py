"""Particle initialization (port of the bit-faithful path of
:mod:`ppsim_tpu.initlib`).

The reference initializer (``init_particles``, part1/main.cpp:31-59) places
particles on a shuffled ceil(sqrt(N)) x sy lattice and draws velocities
uniformly from [-1, 1) with ``std::mt19937``. :func:`init_particles_reference`
reproduces it bit for bit, through the native library when it builds (seconds
at n = 20.97M) or the numpy MT19937 below. :func:`init_particles_fast` is the
JAX package's seeded lattice initializer (the 3D path); it draws from a torch
generator, so its permutation and velocities differ from ``jax.random``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ppsim_tpu_torch.config import SimConfig
from ppsim_tpu_torch.state import ParticleState, make_state

__all__ = ["MT19937", "init_particles_reference", "init_particles_fast",
           "init_particles"]

# Above this n the Python draw loop takes minutes; require the native library.
_PY_LOOP_MAX_N = 2_000_000


class MT19937:
    """Minimal MT19937 engine matching ``std::mt19937`` (single-value seed).

    Seeding follows the C++11 algorithm x[0]=seed,
    x[i] = 1812433253*(x[i-1] ^ (x[i-1]>>30)) + i (mod 2^32); blocks of 624
    outputs are generated with vectorized numpy tempering.
    """

    N, M = 624, 397
    MATRIX_A = np.uint32(0x9908B0DF)
    UPPER = np.uint32(0x80000000)
    LOWER = np.uint32(0x7FFFFFFF)

    def __init__(self, seed: int):
        x = np.empty(self.N, dtype=np.uint64)
        x[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            x[i] = (1812433253 * (x[i - 1] ^ (x[i - 1] >> np.uint64(30))) + i) & 0xFFFFFFFF
        self._state = x.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist(self) -> np.ndarray:
        # The generation pass updates the state in place: iteration i reads
        # x[i+M mod N] (and, last, x[0]) after earlier iterations rewrote
        # them. The first N-M elements read only old state; the rest read new
        # values with lag N-M, so chunks of that size stay consistent.
        x = self._state
        N, M = self.N, self.M
        one = np.uint32(1)

        def gen(y, src):
            mag = np.where((y & one).astype(bool), self.MATRIX_A, np.uint32(0))
            return src ^ (y >> one) ^ mag

        nxt = np.empty_like(x)
        y = (x[0 : N - M] & self.UPPER) | (x[1 : N - M + 1] & self.LOWER)
        nxt[0 : N - M] = gen(y, x[M:N])
        start = N - M
        while start < N - 1:
            end = min(N - 1, start + (N - M))
            y = (x[start:end] & self.UPPER) | (x[start + 1 : end + 1] & self.LOWER)
            nxt[start:end] = gen(y, nxt[start + M - N : end + M - N])
            start = end
        y = (x[N - 1] & self.UPPER) | (nxt[0] & self.LOWER)
        nxt[N - 1] = gen(y, nxt[M - 1])
        self._state = nxt
        z = nxt.copy()
        z ^= z >> np.uint32(11)
        z ^= (z << np.uint32(7)) & np.uint32(0x9D2C5680)
        z ^= (z << np.uint32(15)) & np.uint32(0xEFC60000)
        z ^= z >> np.uint32(18)
        return z

    def fill(self, count: int) -> None:
        """Ensure at least ``count`` un-consumed outputs are buffered."""
        chunks = [self._buf[self._pos :]]
        have = chunks[0].shape[0]
        while have < count:
            c = self._twist()
            chunks.append(c)
            have += c.shape[0]
        self._buf = np.concatenate(chunks)
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= self._buf.shape[0]:
            self.fill(self.N)
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


def _uniform_int(gen: MT19937, upper: int) -> int:
    """libstdc++ ``uniform_int_distribution<int>(0, upper)`` downscaling path."""
    urngrange = 0xFFFFFFFF
    uerange = upper + 1
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        r = gen.next_u32()
        if r < past:
            return r // scaling


def _uniform_float_pm1(gen: MT19937) -> np.float32:
    """libstdc++ ``uniform_real_distribution<float>(-1, 1)``: one draw,
    ``c = float(u) / 2^32`` clamped below 1, result ``c * 2 - 1``."""
    u = gen.next_u32()
    c = np.float32(np.float32(u) / np.float32(4294967296.0))
    if c >= np.float32(1.0):
        c = np.nextafter(np.float32(1.0), np.float32(0.0))
    return np.float32(c * np.float32(2.0) + np.float32(-1.0))


def init_particles_reference(num_parts: int, size: float, seed: int):
    """Bit-faithful reimplementation of the reference ``init_particles``
    (part1/main.cpp:31-59). Returns float64 numpy ``pos, vel`` of shape
    (N, 2). ``seed`` must be nonzero (the reference reads random_device for
    seed 0)."""
    if seed == 0:
        raise ValueError("seed 0 means 'nondeterministic' in the reference; pick a nonzero seed")
    from ppsim_tpu_torch import native

    if native.available():
        return native.native_init(num_parts, size, seed)
    if num_parts > _PY_LOOP_MAX_N:
        raise RuntimeError(
            f"n={num_parts}: the Python MT19937 loop would take hours; the "
            "native initializer needs g++ (native/ppsim_native.cpp)")
    gen = MT19937(seed)
    gen.fill(max(num_parts * 4, 1024))

    sx = int(math.ceil(math.sqrt(float(num_parts))))
    sy = (num_parts + sx - 1) // sx

    shuffle = np.arange(num_parts, dtype=np.int64)
    pos = np.empty((num_parts, 2), dtype=np.float64)
    vel = np.empty((num_parts, 2), dtype=np.float64)

    for i in range(num_parts):
        j = _uniform_int(gen, num_parts - i - 1)
        k = int(shuffle[j])
        shuffle[j] = shuffle[num_parts - i - 1]

        pos[i, 0] = size * (1.0 + (k % sx)) / (1 + sx)
        pos[i, 1] = size * (1.0 + (k // sx)) / (1 + sy)

        vel[i, 0] = float(_uniform_float_pm1(gen))
        vel[i, 1] = float(_uniform_float_pm1(gen))

    return pos, vel


def init_particles_fast(num_parts: int, size: float, seed: int, ndim: int = 2,
                        device="cpu"):
    """The JAX package's ``init_particles_fast`` lattice, drawn with an
    explicit ``torch.Generator(device).manual_seed(seed)``: a shuffled
    ceil(sqrt(N)) x sy lattice in 2D, ceil(N^(1/3))^2 x sz in 3D (the
    stretch-config analog; the reference is 2D-only), velocities U[-1, 1).
    The lattice positions are the JAX package's float32 values; the
    permutation and velocities follow torch's generator, not ``jax.random``.
    Returns float32 ``(pos, vel)`` tensors on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    k = torch.randperm(num_parts, generator=gen, device=device)
    if ndim == 2:
        sx = int(math.ceil(math.sqrt(float(num_parts))))
        sy = (num_parts + sx - 1) // sx
        cells = ((k % sx, sx), (torch.div(k, sx, rounding_mode="floor"), sy))
    else:
        sx = int(math.ceil(float(num_parts) ** (1.0 / 3.0)))
        sy = sx
        sz = (num_parts + sx * sy - 1) // (sx * sy)
        cells = ((k % sx, sx),
                 (torch.div(k, sx, rounding_mode="floor") % sy, sy),
                 (torch.div(k, sx * sy, rounding_mode="floor"), sz))
    L = float(np.float32(size))
    # divide by a device tensor: CUDA turns division by a Python scalar into
    # a multiply by its reciprocal, which would move positions by an ulp
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    pos = torch.stack([L * (1.0 + idx.to(torch.float32)) / f(1 + s)
                       for idx, s in cells], dim=-1)
    vel = torch.rand((num_parts, ndim), generator=gen, device=device,
                     dtype=torch.float32) * 2.0 - 1.0
    return pos, vel


def init_particles(config: SimConfig, seed: int, method: str = "auto",
                   device="cpu") -> ParticleState:
    """Initial :class:`ParticleState` for a config, on ``device``.

    ``method``: ``"reference"`` (2D, bit-faithful; seed must be nonzero),
    ``"fast"`` (the seeded lattice of :func:`init_particles_fast`, 2D or
    3D) or ``"auto"``: the reference initializer in 2D, with seed 0
    replaced by a fresh random seed as the reference's random_device
    fallback does, and ``"fast"`` in 3D.
    """
    if method not in ("auto", "reference", "fast"):
        raise ValueError(f"unknown init method {method!r} (auto | reference | fast)")
    if method == "auto" and seed == 0:
        seed = int(np.random.SeedSequence().generate_state(1)[0]) or 1
    if method == "auto":
        method = "reference" if config.ndim == 2 else "fast"
    if method == "fast":
        pos, vel = init_particles_fast(config.num_parts, config.size, seed,
                                       ndim=config.ndim, device=device)
        return make_state(pos, vel, dtype=config.torch_dtype, device=device)
    if config.ndim != 2:
        raise ValueError("the bit-faithful reference initializer is 2D-only "
                         "(the reference has no 3D form); use method='fast'")
    pos, vel = init_particles_reference(config.num_parts, config.size, seed)
    return make_state(pos, vel, dtype=config.torch_dtype, device=device)
