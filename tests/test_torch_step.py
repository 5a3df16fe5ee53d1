"""Port parity: K1's plain twin (``grid_step_plain``) against the JAX
package's fused step kernel (``grid_step_pallas`` in interpret mode) and
against the JAX XLA twin, at tiny geometry, including a multi-bounce wall
case. The kernel itself is compared with this twin on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsim_tpu.config import SimConfig as JConfig
from ppsim_tpu.initlib import init_particles_reference
from ppsim_tpu.ops import grid_ops as J
from ppsim_tpu.ops.pallas_grid import grid_step_pallas

from ppsim_tpu_torch.convert import slab_state_from_numpy
from ppsim_tpu_torch.ops import grid_ops as T
from ppsim_tpu_torch.ops.cuda_grid import grid_step_plain

# The Pallas kernel is symmetric (Newton 3) with another op order in the
# pair coefficient, so the sums differ in the last bits: positions to 1e-6
# absolute, velocities (up to ~3e3 in the bounce case) to 1e-5 relative.
RTOL, ATOL = 1e-5, 1e-6


def _tiny_slab(bounce: bool):
    """Packed reference-init slab at tiny_grid_config geometry, drifted by up
    to 0.45 bins so pairs interact; with ``bounce``, a few particles get
    speeds that carry them several box lengths (multi-bounce wall fold)."""
    cfg = JConfig(num_parts=200, grid_bin_scale=3.0, grid_capacity=6,
                  evac_capacity=2, rebin_every=4)
    jg = J.SlabGeometry.for_config(cfg)
    pos, vel = init_particles_reference(cfg.num_parts, cfg.size, 42)
    slab, ovf = J.slab_from_particles(jnp.asarray(pos, jnp.float32),
                                      jnp.asarray(vel, jnp.float32), jg)
    assert int(ovf) == 0
    rng = np.random.default_rng(5)
    xl, yl, vx, vy = (np.array(f) for f in slab[:4])
    live = np.asarray(slab.pid) >= 0
    bs = jg.bin_size
    xl[live] += rng.uniform(-0.45 * bs, 0.45 * bs, live.sum()).astype(np.float32)
    yl[live] += rng.uniform(-0.45 * bs, 0.45 * bs, live.sum()).astype(np.float32)
    if bounce:
        idx = np.argwhere(live)[:12]
        for k, (s, r, c) in enumerate(idx):
            # |v| dt up to ~4.7 box lengths, both signs, both axes
            vx[s, r, c] = (-1) ** k * 3000.0
            vy[s, r, c] = (-1) ** (k // 2) * (500.0 + 200.0 * k)
    arrays = (xl, yl, vx, vy, np.asarray(slab.pid))
    return cfg, jg, arrays


@pytest.mark.parametrize("bounce", [False, True])
def test_step_plain_matches_pallas_interpret(bounce):
    cfg, jg, arrays = _tiny_slab(bounce)
    tg = T.SlabGeometry(**dataclasses.asdict(jg))
    ts = slab_state_from_numpy(*arrays)
    args = (cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size)
    want = grid_step_pallas(*(jnp.asarray(a) for a in arrays[:4]), jg, *args,
                            interpret=True)
    got = grid_step_plain(*ts[:4], tg, *args)
    assert float(np.abs(np.asarray(want[2]) - arrays[2]).max()) > 1e-3  # forces
    for name, g, w in zip(("xl", "yl", "vx", "vy", "speed2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if bounce:
        gx = T.global_positions(ts._replace(xl=got[0], yl=got[1]), tg)
        live = ts.pid >= 0
        for g in gx:
            assert float(g[live].min()) >= 0.0 and float(g[live].max()) <= cfg.size


def test_step_plain_matches_xla_twin():
    """grid_step_plain (sentinel aliveness) equals the JAX XLA twin
    grid_force_xla + grid_move (pid aliveness) under the dead-slot
    invariants (x = BIG, v = 0, pid = -1)."""
    cfg, jg, arrays = _tiny_slab(True)
    tg = T.SlabGeometry(**dataclasses.asdict(jg))
    jslab = J.SlabState(*(jnp.asarray(a) for a in arrays))
    acc = J.grid_force_xla(jslab.xl, jslab.yl, jg, cfg.cutoff, cfg.min_r, cfg.mass)
    jnew, jms = J.grid_move(jslab, acc, jg, cfg.dt, cfg.size)
    got = grid_step_plain(*slab_state_from_numpy(*arrays)[:4], tg, cfg.cutoff,
                          cfg.min_r, cfg.mass, cfg.dt, cfg.size)
    for name, g, w in zip(("xl", "yl", "vx", "vy"), got, jnew):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(torch.sqrt(got[4].max())) == pytest.approx(float(jms), rel=1e-6)
