"""The program's own spans in one traced simulation, and the device's work
under each.

A run with ``--trace 1`` reads the metrics that name a ``ppsim.*`` span or
an engine counter from one more simulation, made after the comparison
(:func:`measure`, once a run): a fresh engine of the cell's configuration,
the seeded state of the run's ``--seed``, the warm-up of the window, and
then one ``Engine.run`` at the mix's ``savefreq`` with the program's spans
on (``ppsim_tpu_torch.profiling.tracing``) under ``torch.profiler`` (CPU and
CUDA). The window and the traced simulation of ``core`` run with the spans
off, so nothing they read changes. A program without spans or counters
gives nothing to read: :func:`measure` returns None at once. On several
ranks (``ranks.py``) every rank makes this simulation, since the engine's
mesh spans them, and rank 0 reports it.

From the profiler's events (:func:`events_of`):

- spans: the host ranges named ``ppsim.*`` (arguments after a space, as
  ``profiling.span_label`` writes them), nested by containment on their
  thread;
- device activities: kernels, copies and memsets; the ranges the profiler
  draws on the device for user annotations are not work and are dropped.
  Each activity goes to the innermost span around its host launch call,
  the runtime call with the activity's correlation id (on the card's
  torch 2.11 every activity has one); one without stays unattributed, and
  the coverage printed to standard error shows it;
- a span's device time is the union of its activities' intervals and its
  descendants'; its self time counts only those whose innermost span it is;
- the device's idle gaps inside ``ppsim.run``, each put down to the
  innermost span over its middle (a table on standard error).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from benchmark.trace import gaps, short_name, union_length

__all__ = ["Ev", "Span", "Reading", "Measured", "events_of", "measure",
           "intersection_length", "PREFIX"]

#: Names of the program's spans.
PREFIX = "ppsim."
#: Host calls that launch device work, by name: the CUDA runtime and driver.
_LAUNCH_PREFIXES = ("cuda", "cu")

Interval = Tuple[float, float]


class Ev(NamedTuple):
    """One profiler event; times in seconds on the trace's clock."""

    name: str
    kind: str  # "span", "launch" or "device"
    start: float
    end: float
    thread: int = 0  # the host thread of a span or launch call
    corr: int = 0  # a launch call and its device activity share it


@dataclasses.dataclass(eq=False)
class Span:
    name: str  # without its arguments
    args: Dict[str, str]
    start: float
    end: float
    thread: int
    parent: Optional["Span"] = None

    @property
    def chain(self) -> Tuple[str, ...]:
        """Its name and its ancestors', innermost first."""
        out, s = [], self
        while s is not None:
            out.append(s.name)
            s = s.parent
        return tuple(out)


def _split(label: str) -> Tuple[str, Dict[str, str]]:
    # profiling.parse_span's rule, kept here: a program without spans has none
    name, _, rest = label.partition(" ")
    return name, dict(kv.split("=", 1) for kv in rest.split() if "=" in kv)


def events_of(prof) -> List[Ev]:
    """The spans, launch calls and device activities of a finished
    ``torch.profiler.profile``, read from its Kineto results (the event
    tree of ``prof.events()`` is not needed and takes seconds to build)."""
    out = []
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    for k in results.events():
        name = k.name()
        where = str(k.device_type()).rsplit(".", 1)[-1]
        a, b = (k.start_ns() - t0) * 1e-9, (k.end_ns() - t0) * 1e-9
        if where == "CPU":
            if name.startswith(PREFIX):
                kind = "span"
            elif name.startswith(_LAUNCH_PREFIXES):
                kind = "launch"
            else:
                continue
            thread = k.start_thread_id()
        elif where == "CUDA" and not (getattr(k, "is_user_annotation", bool)()
                                      or name.startswith(("bench.", PREFIX))):
            kind, thread = "device", 0
        else:
            continue
        out.append(Ev(name, kind, a, b, int(thread), int(k.correlation_id())))
    return out


def intersection_length(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of the unions of ``a`` and of ``b``."""
    def merged(xs):
        out = []
        for s, e in sorted(xs):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            elif e > s:
                out.append([s, e])
        return out

    ma, mb = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(ma) and j < len(mb):
        lo, hi = max(ma[i][0], mb[j][0]), min(ma[i][1], mb[j][1])
        if hi > lo:
            total += hi - lo
        if ma[i][1] < mb[j][1]:
            i += 1
        else:
            j += 1
    return total


class Reading:
    """Spans, device activities and what lies under each span."""

    def __init__(self, events: Sequence[Ev]):
        self.spans: List[Span] = []
        by_thread: Dict[int, List[Span]] = collections.defaultdict(list)
        for e in sorted((e for e in events if e.kind == "span"),
                        key=lambda e: (e.start, -e.end)):
            name, args = _split(e.name)
            s = Span(name, args, e.start, e.end, e.thread)
            stack = by_thread[e.thread]
            while stack and stack[-1].end < s.end:
                stack.pop()
            s.parent = stack[-1] if stack else None
            stack.append(s)
            self.spans.append(s)
        self._threads = {}
        for s in self.spans:
            self._threads.setdefault(s.thread, []).append(s)
        self._starts = {t: [s.start for s in ss] for t, ss in self._threads.items()}
        launches = {e.corr: e for e in events if e.kind == "launch"}
        # (start, end, name, chain): chain the spans' names, innermost first,
        # () for an activity launched outside every span or with no launch call
        self.device: List[Tuple[float, float, str, Tuple[str, ...]]] = []
        for e in events:
            if e.kind != "device":
                continue
            launch = launches.get(e.corr)
            inner = self.innermost(launch.start) if launch is not None else None
            chain = inner.chain if inner is not None else ()
            self.device.append((e.start, e.end, short_name(e.name), chain))

    def innermost(self, t: float) -> Optional[Span]:
        """The innermost span running at ``t`` (of the thread whose
        innermost span started last)."""
        best = None
        for thread, spans in self._threads.items():
            k = bisect.bisect_right(self._starts[thread], t) - 1
            s = spans[k] if k >= 0 else None
            while s is not None and s.end < t:
                s = s.parent
            if s is not None and (best is None or s.start > best.start):
                best = s
        return best

    # ---- what the metrics read ------------------------------------------
    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def host_s(self, name: str) -> float:
        """Host seconds in the spans ``name`` (summed; they do not nest in
        one another)."""
        return sum(s.end - s.start for s in self.named(name))

    def device_s(self, name: str, self_only: bool = False) -> float:
        """Device seconds under the spans ``name``: the union of the
        intervals of the activities whose chain holds it (``self_only``:
        whose innermost span it is)."""
        return union_length([(a, b) for a, b, _, chain in self.device
                             if chain and (chain[0] == name if self_only else name in chain)])

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _, _ in self.device])

    @property
    def attributed_s(self) -> float:
        return union_length([(a, b) for a, b, _, chain in self.device if chain])

    def idle_gaps(self, within: str = "ppsim.run") -> List[Interval]:
        """The device's idle intervals inside the spans ``within``."""
        busy = [(a, b) for a, b, _, _ in self.device]
        out = []
        for s in self.named(within):
            out.extend(gaps(busy, s.start, s.end))
        return out

    def idle_under(self, name: str, within: str = "ppsim.run") -> float:
        """Seconds the device is idle while the host is inside a span
        ``name``, within the spans ``within``."""
        return intersection_length(self.idle_gaps(within),
                                   [(s.start, s.end) for s in self.named(name)])

    def idle_table(self, within: str = "ppsim.run", top: int = 10) -> List[list]:
        """``[[label, seconds, gaps], ...]``: the device's idle time inside
        ``within`` by the innermost span over each gap's middle, largest
        first."""
        by, count = collections.Counter(), collections.Counter()
        for a, b in self.idle_gaps(within):
            inner = self.innermost((a + b) / 2.0)
            label = inner.name if inner is not None else "no span"
            by[label] += b - a
            count[label] += 1
        return [[label, s, count[label]] for label, s in by.most_common(top)]


@dataclasses.dataclass
class Measured:
    """The spans-on simulation: its reading and the engine's counters
    before and after it."""

    reading: Reading
    before: dict
    after: dict

    def delta(self, key: str):
        return self.after[key] - self.before[key]

    @property
    def steps(self) -> int:
        return self.delta("steps_run")

    @property
    def frames(self) -> int:
        return self.reading.count("ppsim.frame.gather")

    def report(self, out=sys.stderr) -> None:
        r = self.reading
        linked = sum(1 for d in r.device if d[3])
        print(f"spans: {len(r.spans)} ppsim.* spans; {linked} of {len(r.device)} device "
              "activities under a span by their launch call's correlation id", file=out)
        if r.busy_s > 0:
            share = 100.0 * r.attributed_s / r.busy_s
            print(f"check spans coverage: {share:.4f}% of {r.busy_s:.6f} s busy "
                  f"lies under ppsim.* spans (at least 99: "
                  f"{'yes' if share >= 99.0 else 'no'})", file=out)
            for label, s, n in r.idle_table():
                print(f"spans idle: {label} {s:.6f} s (x{n})", file=out)
        print("spans counters: " + " ".join(
            f"{k}={self.delta(k)}" for k in self.after
            if isinstance(self.after[k], (int, float)) and k in self.before
            and isinstance(self.before[k], (int, float))), file=out)


def _seed(argv: Sequence[str]) -> int:
    """The run's ``--seed``, or 0 outside ``run.py``."""
    argv = list(argv)
    if "--seed" in argv[:-1]:
        return int(argv[argv.index("--seed") + 1])
    return 0


def measure(run) -> Optional[Measured]:
    """The spans-on simulation of ``run``'s cell, made once a run (kept on
    ``run``); None where the program has no spans or counters."""
    if "spans_measured" not in vars(run):
        run.spans_measured = _measure(run)
    return run.spans_measured


def _measure(run) -> Optional[Measured]:
    import torch

    from ppsim_tpu_torch import profiling
    from ppsim_tpu_torch.state import ParticleState

    from benchmark import core
    from benchmark.initstate import lattice_state
    from benchmark.ranks import Ranks
    from benchmark.reference import Physics

    if not hasattr(profiling, "tracing") or not hasattr(profiling, "Counters"):
        return None
    if run.device_name == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
    engine = core._engine(run.config, dev)
    sim = run.config["sim"]
    pos, vel = lattice_state(sim["num_parts"], sim["ndim"], Physics.of(sim).size,
                             _seed(sys.argv), dev)
    state = ParticleState(pos, vel)
    core._warm_up(engine, state, run.mix)
    core._sync(dev)
    before = engine.counters.record()
    with core._profiled(dev) as prof, profiling.tracing():
        engine.run(state, run.mix["nsteps"], run.mix["savefreq"])
        core._sync(dev)
    after = engine.counters.record()
    measured = Measured(Reading(events_of(prof)), before, after)
    del prof, engine, state, pos, vel
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if Ranks(dev).lead:  # every rank makes the simulation; rank 0 reports it
        measured.report()
    return measured
