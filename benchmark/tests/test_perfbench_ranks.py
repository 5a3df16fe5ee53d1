"""A cell on several ranks (``benchmark/ranks.py``): the tiny sharded cell
on 2 and 4 gloo workers gives one result, correct, with the ranks counted;
a rank with a broken timed path makes it incorrect; a worker that dies or
hangs ends the command with no result; a one-card run starts no process
group. On cards, the same cell over NCCL (marked ``cuda``)."""

import datetime
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import core, ranks, spec
from benchmark.tests import tiny

CELL = "tiny2d_sharded.short10"
SEED = 2 ** 31 + 21
#: Seconds a failed or hung run may take to end, start-up of the workers
#: included.
END_S = 120


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def _job(tree, program=None, device="cpu", trace=False, seconds=0.0):
    return ranks.Job(CELL, SEED, seconds, trace, time.time(), device=device, root=tree,
                     bench_dir=tree, program=program)


def _rank():
    return torch.distributed.get_rank()


def _still_on_rank_1(engine):
    """Rank 1's strip keeps its state through every move (the exchanges
    still run, so the ranks stay in step)."""
    move = engine.move_phase

    def still(shards):
        new, speed = move(shards)
        return (shards if _rank() == 1 else new), speed
    engine.move_phase = still


def _raise_on_rank_1(engine):
    if _rank() == 1:
        raise RuntimeError("rank 1 fails before its window")


def _hang_on_rank_1(engine):
    if _rank() == 1:
        time.sleep(3600)


@pytest.mark.parametrize("world,seconds", [(2, 4.0), (4, 0.0)])
def test_sharded_cell_on_gloo_workers(tree, capsys, world, seconds):
    """On 2 workers the window holds several simulations, and rank 0's
    clock ends it for both."""
    results = ranks.run_ranks(_job(tree, seconds=seconds), world, limit_s=600)
    assert len(results) == world
    attempted = {out["attempted"] for out, _ in results}
    assert len(attempted) == 1 and (seconds == 0 or attempted.pop() > 1)
    for out, lines in results:
        assert out["correct"], out["checks"]
        assert out["device"]["count"] == world and out["failed"] == 0
        assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in out["checks"]]
    capsys.readouterr()
    assert ranks.emit(results) == 0
    printed = capsys.readouterr()
    lines = printed.out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(results[0][0]))
    assert printed.err.strip().splitlines() == results[0][1]


def test_traced_sharded_cell_gathers_every_rank(tree):
    results = ranks.run_ranks(_job(tree, trace=True), 2, limit_s=600)
    (out, _), (other, _) = results
    assert out["correct"] and other["correct"], out["checks"]
    # read from the spans-on simulation, which every rank made
    assert "wasted_step_share.saved" in out["metrics"]
    assert out["metrics"].keys() == other["metrics"].keys()


def test_broken_rank_makes_the_run_incorrect(tree):
    results = ranks.run_ranks(_job(tree, program=_still_on_rank_1), 2, limit_s=600)
    assert [out["correct"] for out, _ in results] == [False, False]


LAUNCH = r"""
import sys, time
sys.path.insert(0, {root!r})
from benchmark import ranks
from benchmark.tests import test_perfbench_ranks as t
job = ranks.Job({cell!r}, {seed}, 0.0, False, time.time(), device="cpu", root={tree!r},
                bench_dir={tree!r}, program=t.{program})
sys.exit(ranks.launch(job, 2, limit_s={limit}))
"""


@pytest.mark.parametrize("program,limit", [("_raise_on_rank_1", 600), ("_hang_on_rank_1", 30)])
def test_failed_worker_ends_the_command_with_no_result(tree, program, limit):
    code = LAUNCH.format(root=spec.ROOT, cell=CELL, seed=SEED, tree=tree, program=program,
                         limit=limit)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=END_S + 60)
    took = time.time() - t0
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr
    assert took < END_S, took


class _Started(Exception):
    pass


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_worker_group_times_out_at_the_launchers_limit(monkeypatch, tree, device, backend):
    """The launcher hands its limit to each worker, which starts its process
    group with that timeout: the launcher's limit is the only clock (NCCL's
    own default would end a collective after 10 minutes)."""
    import torch.multiprocessing as tmp

    launched, started = {}, {}

    def start_processes(fn, args, **kwargs):
        launched.update(fn=fn, args=args)
        raise _Started

    def init_process_group(backend, **kwargs):
        started.update(kwargs, backend=backend)
        raise _Started

    monkeypatch.setattr(tmp, "start_processes", start_processes)
    monkeypatch.setattr(torch.distributed, "init_process_group", init_process_group)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(key, "")  # restored after the worker sets them
    with pytest.raises(_Started):
        ranks.run_ranks(_job(tree, device=device), 2, limit_s=777.5)
    with pytest.raises(_Started):
        launched["fn"](0, *launched["args"])
    assert started["backend"] == backend and started["world_size"] == 2
    assert started["timeout"] == datetime.timedelta(seconds=777.5)


def test_one_card_run_starts_no_process_group(tree):
    out, _ = core.run_cell("tiny2d.short", SEED, 0.0, False, time.time(), device="cpu",
                           root=tree, bench_dir=tree)
    assert not torch.distributed.is_initialized()
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "monitor_warnings", "checks"]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert out["correct"], out["checks"]


def test_one_rank_helper_is_the_identity():
    r = ranks.Ranks(torch.device("cpu"))
    assert (r.world, r.rank, r.many, r.lead) == (1, 0, False, True)
    assert r.agree(True) is True and r.agree(False) is False
    assert r.max([1.5, 2]) == [1.5, 2] and r.gather([3.0, 4.0]) == [[3.0, 4.0]]
    assert r.from_lead({"a": 1}) == {"a": 1}
    r.barrier()
    r.all_done()
    r.check_same(torch.zeros(3))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cell_over_nccl_on_cards(cuda_card, tree, world):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    results = ranks.run_ranks(_job(tree, device="cuda", trace=True), world, limit_s=300)
    assert len({out["attempted"] for out, _ in results}) == 1
    out = results[0][0]
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == world
    assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
