"""A cell on several cards: one worker process a card under
``torch.distributed``, and what a run of ``core.run_cell`` does across
them.

``run.py`` calls :func:`launch` for a cell whose ``chips`` is more than 1.
The launcher spawns one worker a card on this host
(``torch.multiprocessing.start_processes``), each with ``RANK`` =
``LOCAL_RANK`` = its index, ``WORLD_SIZE`` = the cards and ``MASTER_ADDR``
/ ``MASTER_PORT`` a free port on 127.0.0.1. A worker sits on
``cuda:LOCAL_RANK``, starts the process group (NCCL on cards, gloo on the
CPU) before the engine, so that the program's ``DistMesh.from_env`` reuses
it, with the launcher's limit as the group's timeout (a collective may
wait as long as the run may last: at a size that fills four cards rank 0's
comparison takes minutes while the others wait for its numbers), and runs
the cell with the command's arguments (spawned workers get the command's
``sys.argv``, whose ``--seed`` ``spans.measure`` reads) and the command's
start, from which ``setup_s`` counts. Each worker hands its
result to the launcher, which prints rank 0's as the command's result once
every worker has exited 0. When a worker exits otherwise, the launcher
stops the others and prints no result; it waits at most ``LIMIT_S``
seconds from the command's start.

Inside ``run_cell``, :class:`Ranks` is the run's view of the ranks: every
engine call runs on every rank in the same order, and ``Ranks`` agrees the
window, reduces what the ranks measured and hands rank 0's comparison to
all. With one rank (no process group) each of its methods returns at once,
so a one-card run makes the calls it made before.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from benchmark import spec

__all__ = ["Ranks", "Job", "RankError", "run_ranks", "emit", "launch", "LIMIT_S"]

#: Seconds from the command's start after which the launcher stops its
#: workers (a checkout's first run, which builds the kernels, has 1200).
LIMIT_S = 1140.0

Result = Tuple[dict, List[str]]  # run_cell's (result, check lines)


class Ranks:
    """The ranks of one run: the default process group's, or one rank alone
    (no group), for which every method returns at once and touches no
    device."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        grouped = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if grouped else 1
        self.rank = dist.get_rank() if grouped else 0

    @property
    def many(self) -> bool:
        return self.world > 1

    @property
    def lead(self) -> bool:
        """Rank 0: it compares, and only it prints."""
        return self.rank == 0

    def _tensor(self, values: Sequence[float]) -> torch.Tensor:
        # float64: exact for byte counts
        return torch.tensor(list(values), dtype=torch.float64, device=self.dev)

    def barrier(self) -> None:
        if self.many:
            dist.barrier(device_ids=[self.dev.index] if self.dev.type == "cuda" else None)

    def all_done(self) -> None:
        """Returns once every rank has called it. Each rank synchronizes its
        card before, so on return every card has finished."""
        if self.many:
            t = self._tensor([1.0])
            dist.all_reduce(t)
            t.item()  # waits for the all-reduce

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if not self.many:
            return flag
        t = self._tensor([float(flag)])
        dist.broadcast(t, 0)
        return bool(t.item())

    def max(self, values: Sequence[float]) -> List[float]:
        """The elementwise max of ``values`` over the ranks."""
        if not self.many:
            return list(values)
        t = self._tensor(values)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    def gather(self, values: Sequence[float]) -> List[List[float]]:
        """Every rank's ``values`` (as many on each), in rank order."""
        if not self.many:
            return [list(values)]
        t = self._tensor(values)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return [p.tolist() for p in parts]

    def from_lead(self, obj):
        """Rank 0's ``obj`` (a picklable value), on every rank."""
        if not self.many:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, 0, device=self.dev)
        return box[0]

    def check_same(self, *tensors: torch.Tensor) -> None:
        """Raises on every rank unless every rank holds ``tensors`` equal to
        rank 0's: each compares its own with rank 0's, and an all-reduce
        collects the verdicts."""
        if not self.many:
            return
        differ = 0.0
        for x in tensors:
            theirs = x if self.lead else torch.empty_like(x)
            dist.broadcast(theirs, 0)
            if not torch.equal(theirs, x):
                differ = 1.0
            del theirs
        if self.max([differ])[0]:
            raise RuntimeError("the seeded state differs between the ranks")


@dataclasses.dataclass(frozen=True)
class Job:
    """One run of a cell, as ``run_cell`` takes it; ``device`` "cuda" puts
    rank r on ``cuda:r`` under NCCL, "cpu" every rank on the CPU under
    gloo."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    t_start: float  # the command's start, on time.time()'s clock
    device: str = "cuda"
    root: str = spec.ROOT
    bench_dir: str = spec.BENCH_DIR
    program: Optional[Callable] = None  # run_cell's hook, on every rank


class RankError(RuntimeError):
    """A worker failed or sent nothing, or the time limit passed."""


def _worker(rank: int, world: int, port: int, job: Job, results, limit_s: float) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from benchmark import core

    timeout = datetime.timedelta(seconds=limit_s)
    if job.device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev,
                                timeout=timeout)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group("gloo", rank=rank, world_size=world, timeout=timeout)
    out, lines = core.run_cell(job.cell, job.seed, job.seconds, job.trace, job.t_start,
                               device=dev, root=job.root, bench_dir=job.bench_dir,
                               program=job.program)
    dist.destroy_process_group()
    loaded = spec.forbidden_modules(sys.modules)
    if loaded:
        print(f"no result: rank {rank} loaded forbidden modules: {loaded}", file=sys.stderr)
        sys.exit(3)
    results.put((rank, out, lines))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(job: Job, world: int, limit_s: float = LIMIT_S) -> List[Result]:
    """Every rank's ``(result, check_lines)`` of one run of ``job`` on
    ``world`` workers, in rank order. Raises RankError, with every worker
    stopped, when one exits non-zero or sends no result, or when
    ``limit_s`` seconds have passed since ``job.t_start``."""
    import torch.multiprocessing as tmp

    results = tmp.get_context("spawn").SimpleQueue()
    procs = tmp.start_processes(_worker, args=(world, _free_port(), job, results, limit_s),
                                nprocs=world, join=False, start_method="spawn")
    got = {}
    try:
        while True:
            try:
                done = procs.join(timeout=0.5)  # on a failure it stops the others
            except (tmp.ProcessExitedException, tmp.ProcessRaisedException) as err:
                raise RankError(f"a worker failed: {err}") from None
            while not results.empty():  # drained as it fills: a put never blocks
                rank, out, lines = results.get()
                got[rank] = (out, lines)
            if done:
                break
            if time.time() - job.t_start > limit_s:
                raise RankError(f"the workers ran past {limit_s:.0f} s")
    finally:
        _stop(procs.processes)
    missing = [r for r in range(world) if r not in got]
    if missing:
        raise RankError(f"rank(s) {missing} exited 0 with no result")
    return [got[r] for r in range(world)]


def emit(results: Sequence[Result]) -> int:
    """Prints rank 0's result as the command's (the check lines last on
    standard error, the JSON line last on standard output) and returns 0;
    returns 1 with no result where the ranks ran different numbers of
    simulations, 3 where this process holds a forbidden module."""
    attempted = [out["attempted"] for out, _ in results]
    if len(set(attempted)) != 1:
        print(f"no result: the ranks attempted {attempted} simulations", file=sys.stderr)
        return 1
    loaded = spec.forbidden_modules(sys.modules)
    if loaded:
        print(f"no result: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    out, lines = results[0]
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


def launch(job: Job, world: int, limit_s: float = LIMIT_S) -> int:
    """One run of ``job`` on ``world`` workers, printed as :func:`emit`
    prints it; 1 and no result where a worker failed or the time ran out."""
    try:
        results = run_ranks(job, world, limit_s)
    except RankError as err:
        print(f"no result: {err}", file=sys.stderr)
        return 1
    return emit(results)
