"""What one run measured: the requests of the window with their spans,
the harness's own spans, summed counters, and the device trace.  The
metric readers (``tomobench/metrics/<name>.py``) take a :class:`Record`
and nothing else."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable


@dataclasses.dataclass
class Span:
    """A named interval on the host's epoch clock (seconds)."""

    name: str
    start: float
    end: float
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Request:
    """One request of the window.

    ``due``: when it was due (closed loop: when the client sent it);
    ``start``: when the system began on it (the runner was built, or
    its first job was dispatched); ``end``: when its last volume was in
    host memory, or when the harness gave up on it (``ok`` False).
    ``slices``: reconstructed slices it returns.  ``spans``: the
    program's spans of the request (``plugin.<name>.<phase>``,
    ``queue.wait``).  ``work``: the shapes of its steps, which the
    frozen yardsticks count (``fbp``: slices, angles, n_det, out_size of
    each backprojection step; ``raw_bytes``: the correction's raw
    input)."""

    index: int
    due: float
    start: float
    end: float
    ok: bool
    slices: int
    spans: list[Span] = dataclasses.field(default_factory=list)
    work: dict[str, Any] = dataclasses.field(default_factory=dict)
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.end - self.due


@dataclasses.dataclass
class DeviceSummary:
    """The device trace over the window: busy seconds per card (the
    union of its kernels, copies and sets), the window's length, the
    operations that took most time, and the idle time by what the host
    was doing."""

    busy_s: list[float]
    window_s: float
    device_ops: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]

    @property
    def mean_busy_s(self) -> float:
        return sum(self.busy_s) / max(len(self.busy_s), 1)


@dataclasses.dataclass
class Record:
    """One run's measurements (see the module docstring)."""

    workload: str
    chips: int
    t0: float
    t1: float
    requests: list[Request]
    host_spans: list[Span] = dataclasses.field(default_factory=list)
    stats: dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: float | None = None
    device: DeviceSummary | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def done(self) -> list[Request]:
        return [r for r in self.requests if r.ok]

    def failed(self) -> list[Request]:
        return [r for r in self.requests if not r.ok]


def quantile(values: Iterable[float], q: float) -> float | None:
    """The nearest-rank ``q`` quantile (the smallest value with at least
    a share ``q`` of the values at or below it); None for no values."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q * len(v)) - 1)]


def union_seconds(intervals: Iterable[tuple[float, float]],
                  lo: float | None = None, hi: float | None = None) -> float:
    """Seconds covered by the union of ``intervals``, clipped to
    [lo, hi] where given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[tuple[float, float]]
           ) -> list[tuple[float, float]]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
