"""The roofline probes of the port (``ppsim_tpu_torch/roofline.py`` and
``ops/cuda_roofline.py``) against ``bench/mfu.py`` on the CPU.

``bench/mfu.py`` builds its two Pallas kernels inside the probe functions
and returns only a rate; the tests load it by path, run its ``pallas_call``
in interpret mode and catch the scalar its ``_sync_scalar`` fences on
(y[0, 0]; its input is ``ones * 0.999``, so every element equals it). Its
step numbers run with ``phase_times``, ``get_engine`` and ``init_particles``
stubbed on both sides (mfu.py imports them inside the function), so no JAX
engine compiles. Nothing in ``bench/`` changes.
"""

import ast
import functools
import importlib.util
import io
import json
import os
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import ppsim_tpu.engines
import ppsim_tpu.initlib
import ppsim_tpu.profiling
from jax.experimental import pallas as pl

import ppsim_tpu_torch.engines
import ppsim_tpu_torch.initlib
import ppsim_tpu_torch.profiling
from ppsim_tpu_torch import roofline
from ppsim_tpu_torch.ops.cuda_roofline import (
    fma_chain_cuda, fma_chain_plain, stream_add_cuda, stream_add_plain,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The probes at a size the interpret mode runs in a second or two.
FMA_SMALL = dict(iters=4, rows=256, cols=128, calls=2)
STREAM_SMALL = dict(mb=4, calls=2)
# A fixed split for the stubbed phase_times, seconds a step.
TIMES = {"step": 1.6e-3, "force+move": 1.4e-3, "rebin": 1.7e-4, "overhead": 3e-5}
MFU_KEYS = {"device_kind", "platform", "vpu_f32_peak_tflops", "hbm_stream_gbps",
            "phase_ms", "grid", "pair_planes_per_bin", "pairs_per_step",
            "useful_pair_fraction", "kernel_flops_per_step", "force_move_s", "step_s",
            "kernel_tflops", "vpu_utilization", "pair_interactions_per_sec"}


@pytest.fixture
def mfu(monkeypatch):
    """``bench/mfu.py`` loaded by path, its Pallas calls in interpret mode;
    ``mfu.fenced`` collects the scalars its probes fence on."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # mfu.py inserts "."
    spec = importlib.util.spec_from_file_location(
        "_mfu_under_test", os.path.join(ROOT, "bench", "mfu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, pallas_call=functools.partial(pl.pallas_call,
                                                              interpret=True)))
    mod.fenced = []
    sync = mod._sync_scalar

    def fence(x):
        mod.fenced.append(sync(x))
        return mod.fenced[-1]

    monkeypatch.setattr(mod, "_sync_scalar", fence)
    return mod


def _stub_steps(monkeypatch, engines, initlib, profiling, seen):
    """Stubs for the step numbers' engine, init and phase_times that record
    their arguments in ``seen`` and return :data:`TIMES`."""
    def get_engine(name, cfg, **kw):
        seen["engine"] = name
        return types.SimpleNamespace(name=name)

    def init_particles(cfg, seed, method="auto", **kw):
        seen["init"] = (cfg.num_parts, seed, method)

    def phase_times(engine, state, steps=50):
        seen["steps"] = steps
        return dict(TIMES)

    monkeypatch.setattr(engines, "get_engine", get_engine)
    monkeypatch.setattr(initlib, "init_particles", init_particles)
    monkeypatch.setattr(profiling, "phase_times", phase_times)


@pytest.mark.parametrize("chains", [1, 2, 8])
def test_fma_chain_plain_matches_jax_probe(mfu, chains):
    """The twin, chained ``calls`` times on ``ones * 0.999``, against the
    TPU kernel in interpret mode, within rtol 1e-6: XLA's CPU backend
    contracts ``acc * b + a`` into one FMA (one rounding, as the card's
    FFMA), where the twin rounds the product and the sum apart, so the two
    part by up to half an ulp (2^-24 relative) a step; the second call
    starts from the first's output, and acc grows about as its input to
    the iters-th power, so its 4 steps carry the first call's error about
    5-fold: (4 * 5 + 4) / 2 ulps ~ 7e-7 at worst (one ulp, 1.2e-7, seen)."""
    mfu.vpu_peak_flops(chains=chains, **FMA_SMALL)
    want = mfu.fenced[-1]
    assert len(set(mfu.fenced)) == 1  # the compile run and the 5 timed runs
    x = torch.full((FMA_SMALL["rows"], FMA_SMALL["cols"]), 0.999)
    y = x
    for _ in range(FMA_SMALL["calls"]):
        y = fma_chain_plain(y, FMA_SMALL["iters"], chains)
    assert np.isfinite(want)
    assert torch.equal(y, torch.full_like(y, float(y[0, 0])))
    assert torch.allclose(y, torch.full_like(y, want), rtol=1e-6, atol=0)


def test_stream_add_plain_matches_jax_probe(mfu):
    """``x + 1`` twice from ones is 3 everywhere, bitwise the TPU copy's."""
    mfu.hbm_stream_bw(**STREAM_SMALL)
    assert mfu.fenced[-1] == 3.0
    n = STREAM_SMALL["mb"] * 1024 * 1024 // 4
    y = torch.ones((n // 2048, 2048))
    for _ in range(STREAM_SMALL["calls"]):
        y = stream_add_plain(y)
    assert torch.equal(y, torch.full_like(y, mfu.fenced[-1]))


@pytest.mark.parametrize("chains", [1, 4, 8])
def test_fma_chain_plain_matches_float64_loop(chains):
    """On a seeded input in [0.5, 1), the twin tracks the same recurrence
    in float64 (from the float32 constant) within rtol 1e-6 over 8 steps:
    float32 rounds each op to 2^-24 relative, b's two roundings reach acc
    about iters-fold (acc grows as b^iters) and each step adds two more, so
    ~(3 * 8 + 2) * 2^-24 = 1.5e-6 if every rounding fell the same way; they
    fall both ways, and this input's largest is 6.8e-7. Every term is
    positive, so the sum over chains cancels nothing."""
    iters = 8
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 1.0, (64, 48)).astype(np.float32)
    got = fma_chain_plain(torch.from_numpy(a), iters, chains).numpy()
    a64 = a.astype(np.float64)
    b = a64 * float(np.float32(1.0000001)) + 0.5
    accs = [a64 + k for k in range(chains)]
    for _ in range(iters):
        accs = [acc * b + a64 for acc in accs]
    want = sum(accs[1:], accs[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_wrappers_run_the_twins_on_cpu_only():
    """CPU tensors run the twins (no launch counted); a tensor on any other
    device raises; ``out`` is written in place."""
    x = torch.linspace(0.5, 1.0, 37)
    n_fma, n_stream = fma_chain_cuda.launches, stream_add_cuda.launches
    assert torch.equal(fma_chain_cuda(x, 5, 4), fma_chain_plain(x, 5, 4))
    out = torch.empty_like(x)
    assert stream_add_cuda(x, out=out) is out
    assert torch.equal(out, x + 1)
    assert (fma_chain_cuda.launches, stream_add_cuda.launches) == (n_fma, n_stream)
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fma_chain_cuda(meta, 4, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stream_add_cuda(meta)
    with pytest.raises(ValueError, match="out must be"):
        stream_add_plain(x, out=torch.empty(36))


def test_step_kernel_numbers_match_mfu(mfu, monkeypatch):
    """Same n, same times: every key of the step numbers equal, and the
    engine, init and window are mfu.py's (the port's ``cuda`` for
    ``pallas``); then both mains, with the probes' rates fixed, print the
    same derived rates."""
    n = 16_384
    jseen, tseen = {}, {}
    _stub_steps(monkeypatch, ppsim_tpu.engines, ppsim_tpu.initlib, ppsim_tpu.profiling,
                jseen)
    _stub_steps(monkeypatch, ppsim_tpu_torch.engines, ppsim_tpu_torch.initlib,
                ppsim_tpu_torch.profiling, tseen)
    want = mfu.step_kernel_numbers(n)
    got = roofline.step_kernel_numbers(n, device="cpu")
    assert got == want
    assert got["pair_planes_per_bin"] > 0 and got["pairs_per_step"] > 0
    assert jseen == {"engine": "pallas", "init": (n, 42, "fast"), "steps": 40}
    assert tseen == {**jseen, "engine": "cuda"}

    for mod in (mfu, roofline):
        monkeypatch.setattr(mod, "vpu_peak_flops", lambda **kw: 5.5e13)
        monkeypatch.setattr(mod, "hbm_stream_bw", lambda **kw: 2.9e12)
    lines = []
    for main, argv in ((mfu.main, ["-n", str(n)]),
                       (roofline.main, ["-n", str(n), "--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv) == 0
        lines.append(json.loads(buf.getvalue()))
    jout, tout = lines
    assert MFU_KEYS <= set(jout) and MFU_KEYS <= set(tout)
    for key in MFU_KEYS - {"device_kind", "platform"}:
        assert tout[key] == jout[key], key


@pytest.mark.parametrize("skip_step", [False, True])
def test_main_prints_one_json_line_on_cpu(monkeypatch, skip_step):
    """``--device cpu`` with the probes at tiny sizes and the step stubbed:
    one parseable line with mfu.py's keys, the CPU named as the device."""
    _stub_steps(monkeypatch, ppsim_tpu_torch.engines, ppsim_tpu_torch.initlib,
                ppsim_tpu_torch.profiling, {})
    monkeypatch.setattr(roofline, "vpu_peak_flops", functools.partial(
        roofline.vpu_peak_flops, chains=2, **FMA_SMALL))
    monkeypatch.setattr(roofline, "hbm_stream_bw", functools.partial(
        roofline.hbm_stream_bw, **STREAM_SMALL))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert roofline.main(["-n", "16384", "--device", "cpu"]
                             + ["--skip-step"] * skip_step) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    probes = {"device_kind", "platform", "vpu_f32_peak_tflops", "hbm_stream_gbps"}
    assert set(out) == (probes | {"power_limit"} if skip_step
                        else MFU_KEYS | {"power_limit"})
    assert (out["device_kind"], out["platform"], out["power_limit"]) == ("cpu", "cpu", None)
    assert out["vpu_f32_peak_tflops"] >= 0 and out["hbm_stream_gbps"] > 0


def test_roofline_defaults_to_the_card():
    """``main([])`` and the probes run on the card by default and raise
    without one; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    for call in (lambda: roofline.main([]), roofline.vpu_peak_flops,
                 roofline.hbm_stream_bw, lambda: roofline.step_kernel_numbers(16_384)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


@pytest.mark.parametrize("module", ["roofline.py", os.path.join("ops", "cuda_roofline.py")])
def test_roofline_modules_import_nothing_of_jax_or_bench(module):
    with open(os.path.join(ROOT, "ppsim_tpu_torch", module)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "ppsim_tpu", "bench", "mfu"), name
