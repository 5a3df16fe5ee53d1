"""The command: no card means no result; the last line's keys; no module
of the JAX stack or of the JAX package in a run's process; and, on a
card, a tiny cell end to end with its trace."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests import tiny

RUN = os.path.join(spec.BENCH_DIR, "run.py")


def _cmd(*extra):
    return [sys.executable, RUN, "--workload", "hw2_2d_16m.unsaved", "--seed",
            str(2 ** 31 + 3), "--seconds", "1", "--trace", "0", *extra]


def test_no_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(_cmd(), cwd=spec.ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


REHEARSAL = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.core, benchmark.check, benchmark.spec, benchmark.trace
import benchmark.roofline, benchmark.reference, benchmark.initstate
from benchmark import core, spec
for m in spec.load_benchmark()["end_to_end"] + spec.load_benchmark()["per_layer"]:
    spec.load_reader(m["name"])
out, lines = core.run_cell("tiny2d.short10", 2 ** 31 + 5, 0.0, True, time.time(),
                           device="cpu", root={tree!r}, bench_dir={tree!r})
print(json.dumps({{"out": out, "forbidden": spec.forbidden_modules(sys.modules),
                  "loaded": sorted(sys.modules)}}))
"""


def test_rehearsal_loads_no_jax_and_prints_the_keys(tmp_path):
    tree = tiny.make_tree(tmp_path)
    code = REHEARSAL.format(root=spec.ROOT, tree=tree)
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "ppsim_tpu_torch" in got["loaded"] and "torch" in got["loaded"]
    out = got["out"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = spec.load_benchmark(tree)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.cuda
def test_without_the_program_no_result(cuda_card, tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark")
    proc = subprocess.run([sys.executable, "benchmark/run.py", *_cmd()[2:]], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny2d.short", "tiny3d.short10"])
def test_tiny_cell_on_the_card(cuda_card, tmp_path, cell):
    from benchmark import core

    tree = tiny.make_tree(tmp_path)
    out, _ = core.run_cell(cell, 2 ** 31 + 9, 0.5, True, 0.0, device=cuda_card,
                           root=tree, bench_dir=tree)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]
    assert out["metrics"]
