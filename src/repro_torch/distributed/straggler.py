"""Straggler detection + mitigation hooks.

A copy of the reference's monitor (standard library only).  On a large
job the common failure mode is not a crash but a slow host (thermal
throttle, ECC retry storm, a flaky link).  The monitor keeps a ring
buffer of per-step wall times; a step slower than ``factor`` × the
rolling median flags a straggler event.  Mitigation is launcher policy,
surfaced here as callbacks:

  * ``on_warn``  — log/emit (default),
  * ``on_evict`` — after ``patience`` consecutive slow steps the
    launcher should checkpoint + restart without the slow host
    (``CheckpointManager.restore``).

One card: exercised by tests with synthetic timings and by
``launch/train.py``'s warnings.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall: float
    median: float
    ratio: float


class StragglerMonitor:
    def __init__(self, *, window: int = 32, factor: float = 2.0,
                 patience: int = 3,
                 on_warn: Callable[[StragglerEvent], None] | None = None,
                 on_evict: Callable[[StragglerEvent], None] | None = None):
        self.window = window
        self.factor = factor
        self.patience = patience
        self.on_warn = on_warn or (lambda e: None)
        self.on_evict = on_evict or (lambda e: None)
        self.times: deque[float] = deque(maxlen=window)
        self.events: list[StragglerEvent] = []
        self._consecutive = 0
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int | None = None) -> None:
        self._step = step if step is not None else self._step + 1
        self._t0 = time.perf_counter()

    def end_step(self, wall: float | None = None) -> StragglerEvent | None:
        if wall is None:
            assert self._t0 is not None, "start_step not called"
            wall = time.perf_counter() - self._t0
        ev = self.observe(self._step, wall)
        self._t0 = None
        return ev

    def observe(self, step: int, wall: float) -> StragglerEvent | None:
        """Feed one step time; returns the event if it was slow."""
        med = statistics.median(self.times) if self.times else wall
        self.times.append(wall)
        if len(self.times) < 4 or med <= 0:
            return None
        ratio = wall / med
        if ratio >= self.factor:
            ev = StragglerEvent(step, wall, med, ratio)
            self.events.append(ev)
            self._consecutive += 1
            if self._consecutive >= self.patience:
                self.on_evict(ev)
            else:
                self.on_warn(ev)
            return ev
        self._consecutive = 0
        return None
