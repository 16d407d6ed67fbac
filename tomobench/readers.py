"""Arithmetic the metric readers share (``metrics/<name>.py``)."""
from __future__ import annotations

from .record import Record, Request, union_seconds

PROCESS = ".process"


def outside_steps_pct(rec: Record) -> float | None:
    """The share (%) of the requests' walls, summed over every completed
    request, that no ``plugin.*.process`` span of the request covers:
    runner set-up, the steps' host work, and the result's read."""
    wall = outside = 0.0
    for r in rec.done():
        w = r.end - r.start
        covered = union_seconds(((s.start, s.end) for s in r.spans
                                 if s.name.startswith("plugin.")
                                 and s.name.endswith(PROCESS)),
                                r.start, r.end)
        wall += w
        outside += w - covered
    return None if wall <= 0 else 100.0 * outside / wall


def idle_pct(rec: Record) -> float | None:
    """100 × (1 − busy / window), averaged over the cell's cards."""
    d = rec.device
    if d is None or d.window_s <= 0 or not d.busy_s:
        return None
    return 100.0 * (1.0 - d.mean_busy_s / d.window_s)


def step_spans(r: Request, plugin: str) -> list[tuple[float, float]]:
    """The distinct ``plugin.<plugin>.process`` intervals of a request (a
    gang's members each carry the one shared step)."""
    return sorted({(s.start, s.end) for s in r.spans
                   if s.name == f"plugin.{plugin}{PROCESS}"})
