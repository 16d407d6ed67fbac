"""Structured event log — one bounded ring of state-transition records.

The port's copy of ``repro.obs.log`` (stdlib only, copied rather than
imported: the port imports nothing of ``repro``).

Metrics (``obs.metrics``) answer "how much / how fast"; traces
(``obs.trace``) answer "where did THIS job's time go".  What
neither answers is "what happened, in order, across the whole cluster" —
the question an operator asks first when a worker dies or an alert
fires.  This module is that answer: every job state transition
(``job.submit``, ``job.lease``, ``job.park``, ``job.requeue``,
``lease.expire``, ``job.complete``) and every SLO alert transition
(``alert.pending`` / ``alert.firing`` / ``alert.resolved``) appends one
JSON-able record here, and ``GET /events`` serves the ring with a
``?since=`` cursor so a client can tail it (``pipeline_serve client
events --follow``).

Every record carries ``trace_id`` / ``job_id`` / ``worker_id`` (empty
string when not applicable — alert records carry the SLO engine's own
trace id), so the event stream joins against traces and job snapshots
without guesswork.

The ring is bounded (``max_events``) with a monotonically increasing
``seq`` per record: a reader that falls behind can detect the gap
(``cursor`` < the first retained ``seq``) instead of silently missing
events.  Thread-safe; appends are O(1) and never block on I/O, so the
queue/scheduler/broker can emit from under their own locks.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any


class EventLog:
    """Bounded, thread-safe ring of structured transition events."""

    def __init__(self, max_events: int = 2048):
        """Args:
            max_events: ring capacity; the oldest records fall off once
                exceeded (``since()`` reports the resulting gap).
        """
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self._seq = 0
        self._lock = threading.Lock()

    def emit(self, event: str, *, trace_id: str = "",
             job_id: str = "", worker_id: str = "",
             **attrs: Any) -> dict[str, Any]:
        """Append one record and return it.

        Args:
            event: dotted transition name (``job.lease``,
                ``alert.firing``...).
            trace_id: the trace this transition belongs to.  Every
                emitter is expected to supply one — the bench harness
                fails CI on records without it.
            job_id / worker_id: identities, empty when not applicable.
            attrs: free-form JSON-able annotations (state, attempt,
                rule, value...).
        """
        rec = {"event": event, "ts": time.time(),
               "trace_id": trace_id, "job_id": job_id,
               "worker_id": worker_id, "attrs": attrs}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._events.append(rec)
        return rec

    @property
    def head(self) -> int:
        """The newest record's ``seq`` (0 while empty) — a cheap
        "anything new?" probe and the callback-gauge feed."""
        with self._lock:
            return self._seq

    def since(self, cursor: int = 0, limit: int | None = None
              ) -> dict[str, Any]:
        """Records with ``seq > cursor``, oldest first.

        Returns ``{"events": [...], "cursor": <new cursor>,
        "dropped": <n>}`` — ``cursor`` is what the caller passes next
        time (the newest served seq, or the input cursor when nothing
        new), and ``dropped`` counts records that fell off the ring
        between the caller's cursor and the first retained record (0
        for a reader that keeps up).
        """
        if cursor < 0:
            raise ValueError(f"cursor must be >= 0, got {cursor}")
        with self._lock:
            out = [e for e in self._events if e["seq"] > cursor]
            first_retained = self._events[0]["seq"] if self._events \
                else self._seq + 1
        if limit is not None and limit >= 0:
            out = out[:limit]
        new_cursor = out[-1]["seq"] if out else cursor
        dropped = max(0, first_retained - cursor - 1)
        return {"events": out, "cursor": new_cursor, "dropped": dropped}

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
