"""What the benchmark reads from a ``torch.profiler`` trace.

A traced window is one span that the benchmark records around its own call
(``record_function``), the device's activities (kernels, copies, memsets)
inside it and the host's operations. Busy time is the length of the union
of the device intervals: a copy stream beside the compute stream overlaps
it, and a sum of durations would count the overlap twice.
"""

from __future__ import annotations

import bisect
import collections
from typing import List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["Interval", "union_length", "gaps", "short_name", "TraceWindow",
           "SPAN_PREFIX"]

#: Names of the benchmark's own spans; never counted as device work.
SPAN_PREFIX = "bench."
#: Host operations looked back over for the one that covers a gap.
_SCAN = 4096

Interval = Tuple[float, float]


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its return type, namespaces of
    no name and parameter list (a ``(`` right after the name), cut to
    ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and k > 0 and name[k - 1] != " ":
            name = name[:k]
            break
    return name[:width]


def _clipped(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    out = [(max(a, lo), min(b, hi)) for a, b in intervals]
    return sorted((a, b) for a, b in out if b > a)


def union_length(intervals: Sequence[Interval], lo: float = float("-inf"),
                 hi: float = float("inf")) -> float:
    """Length of the union of ``intervals`` within ``[lo, hi]``."""
    total, end = 0.0, float("-inf")
    for a, b in _clipped(intervals, lo, hi):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``[lo, hi]`` that no interval covers, in order."""
    out, cur = [], lo
    for a, b in _clipped(intervals, lo, hi):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


class TraceWindow(NamedTuple):
    """One span of a trace; times in seconds on the trace's clock."""

    lo: float
    hi: float
    device: List[Tuple[float, float, str]]  # (start, end, name)
    host: List[Tuple[float, float, str]]

    @property
    def wall_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _ in self.device], self.lo, self.hi)

    def device_ops(self, top: int = 10) -> List[list]:
        """``[[name, seconds], ...]``: device time by operation name within
        the span, largest first."""
        by = collections.Counter()
        for a, b, name in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                by[name] += b - a
        return [[name, s] for name, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """``[[label, seconds], ...]``: the device's idle time within the
        span, grouped by the innermost host operation running at each gap's
        middle (``host: <op> (xN)``, N the gaps), largest first."""
        host = sorted(self.host)
        starts = [x for x, _, _ in host]
        by, count = collections.Counter(), collections.Counter()
        for a, b in gaps([(x, y) for x, y, _ in self.device], self.lo, self.hi):
            mid = (a + b) / 2.0
            # the covering operation that started last is the innermost
            inner = "no operation"
            for k in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 1 - _SCAN), -1):
                if host[k][1] >= mid:
                    inner = host[k][2]
                    break
            label = "host: " + inner
            by[label] += b - a
            count[label] += 1
        return [[f"{label} (x{count[label]})", s] for label, s in by.most_common(top)]

    @classmethod
    def from_events(cls, events, span: str) -> Optional["TraceWindow"]:
        """From ``profile.events()``: the window of the host span named
        ``span``; None if the span or any device activity is missing."""
        lo = hi = None
        device, host = [], []
        for e in events:
            name = e.name
            kind = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if kind == "CPU":
                if name == span:
                    lo, hi = a, b
                elif not name.startswith(SPAN_PREFIX):
                    host.append((a, b, name))
            elif kind == "CUDA" and not name.startswith(SPAN_PREFIX):
                device.append((a, b, short_name(name)))
        if lo is None or not device:
            return None
        return cls(lo, hi, device, host)
