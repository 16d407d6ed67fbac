"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over the measured window, reduced to busy seconds per card, the device
operations that took most time, and the idle time by what the host was
doing then (the innermost harness or program span around the middle of
each idle gap).

The profiler's events are on the host's epoch clock in nanoseconds; a
marker range opened at a known ``time.time_ns()`` gives the offset, so
the spans of the harness and the program (epoch seconds) line up with
the device's intervals.
"""
from __future__ import annotations

import bisect
import collections
import heapq
import time
from typing import Iterable, Sequence

from .record import DeviceSummary, Span, merged

#: the profiler's activity types that occupy a card
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
MARK = "tomobench.clock_mark"
#: what an idle gap is named when no span covers it
UNCOVERED = "host.outside_spans"
TOP = 10


class DeviceTrace:
    """Context manager: profiles the window when ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.offset_ns = 0
        self._mark_ns = 0

    def __enter__(self) -> "DeviceTrace":
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._mark_ns = time.time_ns()
        with record_function(MARK):
            pass
        return self

    def __exit__(self, *exc) -> bool:
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def _events(self):
        """(name, device index, start ns, end ns) of every device
        activity, on the epoch clock."""
        events = self.prof.profiler.kineto_results.events()
        mark = [e for e in events if e.name() == MARK]
        if mark:
            self.offset_ns = self._mark_ns - mark[0].start_ns()
        out = []
        for e in events:
            kind = str(getattr(e, "activity_type", lambda: "")())
            on_device = "CUDA" in str(e.device_type())
            if not on_device or e.is_user_annotation():
                continue
            if kind and kind not in DEVICE_ACTIVITIES:
                continue
            s = e.start_ns() + self.offset_ns
            out.append((e.name(), e.device_index(), s, s + e.duration_ns()))
        return out

    def summary(self, t0: float, t1: float, devices: Sequence[int],
                spans: Iterable[Span]) -> DeviceSummary | None:
        """The window [t0, t1]'s reduction; None when not profiled."""
        if self.prof is None:
            return None
        lo, hi = int(t0 * 1e9), int(t1 * 1e9)
        per_dev: dict[int, list[tuple[int, int]]] = collections.defaultdict(
            list)
        by_name: dict[str, float] = collections.defaultdict(float)
        for name, dev, s, e in self._events():
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            per_dev[dev].append((s, e))
            by_name[name] += (e - s) * 1e-9
        seg_at, seg_name = _innermost_segments(spans)
        busy, gaps = [], collections.defaultdict(float)
        for d in devices:
            iv = merged(per_dev.get(d, []))
            busy.append(sum(e - s for s, e in iv) * 1e-9)
            edges = [lo] + [x for s, e in iv for x in (s, e)] + [hi]
            for g0, g1 in zip(edges[::2], edges[1::2]):
                if g1 > g0:
                    i = bisect.bisect_right(seg_at, (g0 + g1) // 2) - 1
                    gaps[seg_name[i] if i >= 0 else UNCOVERED] += \
                        (g1 - g0) * 1e-9 / len(devices)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return DeviceSummary(busy, t1 - t0, ops, idle)


def _innermost_segments(spans: Iterable[Span]
                        ) -> tuple[list[int], list[str]]:
    """The host timeline cut where the innermost (shortest) covering span
    changes: segment k starts at ``at[k]`` (ns) and is named
    ``names[k]``."""
    edges = []
    for k, sp in enumerate(spans):
        s, e = int(sp.start * 1e9), int(sp.end * 1e9)
        if e > s:
            edges.append((s, 1, k, e - s, sp.name))
            edges.append((e, 0, k, e - s, sp.name))
    edges.sort(key=lambda x: (x[0], x[1]))
    active: list[tuple[int, int, str]] = []
    gone: set[int] = set()
    at: list[int] = []
    names: list[str] = []
    for t, opening, k, length, name in edges:
        if opening:
            heapq.heappush(active, (length, k, name))
        else:
            gone.add(k)
        while active and active[0][1] in gone:
            heapq.heappop(active)
        top = active[0][2] if active else UNCOVERED
        if names and at[-1] == t:
            names[-1] = top
        elif not names or names[-1] != top:
            at.append(t)
            names.append(top)
    return at, names
