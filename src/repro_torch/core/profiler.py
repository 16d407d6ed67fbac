"""Per-plugin profiler — the MPI-profiler analogue (paper §IV.B, Fig 9).

A thin view over a :class:`~repro_torch.obs.trace.Trace`: every
``timer()`` records a ``plugin.<name>.<phase>`` span (epoch timestamps),
and ``record``/``totals``/``report``/``save`` work on top of it.  On the
card the transports end each step with a device synchronise, so a
``process`` span covers the device work and not only the enqueue.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..obs.trace import Span, Trace


@dataclasses.dataclass
class Event:
    """Per-phase event view; the authoritative record is the Span."""

    plugin: str
    phase: str          # 'setup' | 'pre' | 'process' | 'post' | 'io'
    start: float
    end: float
    devices: int = 1
    flops: float | None = None
    bytes: float | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def wall(self) -> float:
        return self.end - self.start


def _span_to_event(s: Span) -> Event:
    a = dict(s.attrs)
    plugin = a.pop("plugin", None)
    phase = a.pop("phase", None)
    if plugin is None or phase is None:
        parts = s.name.split(".")
        plugin = plugin or ".".join(parts[1:-1]) or s.name
        phase = phase or (parts[-1] if len(parts) > 1 else "")
    return Event(plugin, phase, s.start,
                 s.end if s.end is not None else s.start,
                 devices=a.pop("devices", 1), flops=a.pop("flops", None),
                 bytes=a.pop("bytes", None), extra=a)


class Profiler:
    """Record plugin-phase timings as spans on a trace (a private one
    unless the job's trace is passed)."""

    def __init__(self, trace: Trace | None = None,
                 worker_id: str | None = None):
        self.trace = trace if trace is not None else Trace()
        self.worker_id = worker_id

    def record(self, plugin: str, phase: str, start: float, end: float,
               devices: int = 1, flops=None, bytes=None, **extra) -> None:
        attrs: dict[str, Any] = {"plugin": plugin, "phase": phase,
                                 "devices": devices, **extra}
        if flops is not None:
            attrs["flops"] = flops
        if bytes is not None:
            attrs["bytes"] = bytes
        self.trace.record(f"plugin.{plugin}.{phase}", start, end,
                          worker_id=self.worker_id, attrs=attrs)

    class _Timer:
        def __init__(self, prof, plugin, phase, devices, extra):
            self.prof, self.plugin, self.phase = prof, plugin, phase
            self.devices, self.extra = devices, extra

        def __enter__(self):
            self.span = self.prof.trace.begin(
                f"plugin.{self.plugin}.{self.phase}",
                worker_id=self.prof.worker_id,
                attrs={"plugin": self.plugin, "phase": self.phase,
                       "devices": self.devices, **self.extra})
            return self

        def __exit__(self, exc_type, *exc):
            if exc_type is not None:
                self.span.attrs["error"] = exc_type.__name__
            self.prof.trace.finish(self.span)
            return False

    def timer(self, plugin: str, phase: str, devices: int = 1, **extra):
        """Context manager timing one plugin phase (epoch clock)."""
        return Profiler._Timer(self, plugin, phase, devices, extra)

    @property
    def events(self) -> list[Event]:
        """The plugin-phase spans as :class:`Event` records, by start."""
        return [_span_to_event(s) for s in self.trace.spans()
                if s.name.startswith("plugin.")]

    def totals(self, phase: str | None = None) -> dict[str, float]:
        """Wall seconds per plugin, over every phase or only ``phase``."""
        out: dict[str, float] = {}
        for e in self.events:
            if phase is None or e.phase == phase:
                out[e.plugin] = out.get(e.plugin, 0.0) + e.wall
        return out

    def report(self, width: int = 50) -> str:
        """Fig-9-style per-plugin bar chart."""
        events = self.events
        totals = self.totals()
        if not totals:
            return "(no events)"
        tmax = max(totals.values()) or 1.0
        lines = [f"{'plugin':<32} {'wall(s)':>9}  profile"]
        for name, t in totals.items():
            bar = "#" * max(1, int(width * t / tmax))
            lines.append(f"{name:<32} {t:9.4f}  {bar}")
        phases: dict[str, float] = {}
        for e in events:
            phases[e.phase] = phases.get(e.phase, 0.0) + e.wall
        lines.append("")
        lines.append("per-phase: " + "  ".join(
            f"{k}={v:.4f}s" for k, v in sorted(phases.items())))
        return "\n".join(lines)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump([dataclasses.asdict(e) for e in self.events], fh,
                      indent=2, default=str)

    @staticmethod
    def load(path: str) -> "Profiler":
        p = Profiler()
        with open(path) as fh:
            for d in json.load(fh):
                extra = d.pop("extra", {}) or {}
                p.record(d["plugin"], d["phase"], d["start"], d["end"],
                         devices=d.get("devices", 1),
                         flops=d.get("flops"), bytes=d.get("bytes"),
                         **extra)
        return p
