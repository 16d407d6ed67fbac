"""Job tracing: the spans the profiler and the transports record.

The port's copy of the part of ``repro.obs.trace`` that the framework
uses (:class:`Span`, :class:`Trace`, :func:`current_trace`).  Shipping
spans between processes belongs to the service layer, not yet ported.

A :class:`Span` is one timed operation (``compile``,
``plugin.<name>.<phase>``...) with epoch-second timestamps, so spans
from different processes land on one timeline.  A :class:`Trace` is a
thread-safe span collection for one job; its per-thread parent stack
links nested spans automatically (``begin``/``finish``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
import uuid
from typing import Any


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class Span:
    """One timed operation; ``end`` is None while the span is open."""

    name: str
    start: float
    end: float | None = None
    trace_id: str = ""
    span_id: str = dataclasses.field(default_factory=new_span_id)
    parent_id: str | None = None
    worker_id: str | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


class Trace:
    """Thread-safe span collection for one job, with per-(trace, thread)
    parent stacks so nested spans get ``parent_id`` links."""

    def __init__(self, trace_id: str | None = None,
                 worker_id: str | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.worker_id = worker_id
        self._spans: dict[str, Span] = {}
        self._lock = threading.Lock()
        self._stacks = threading.local()

    def _stack(self) -> list[Span]:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    def add(self, span: Span) -> Span:
        """Register ``span`` (idempotent per ``span_id``)."""
        span.trace_id = self.trace_id
        with self._lock:
            self._spans.setdefault(span.span_id, span)
        return span

    def record(self, name: str, start: float, end: float, *,
               worker_id: str | None = None,
               parent_id: str | None = None,
               attrs: dict[str, Any] | None = None) -> Span:
        """Add one finished span; the parent defaults to the thread's
        innermost open span."""
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1].span_id if stack else None
        return self.add(Span(name, start, end,
                             worker_id=worker_id or self.worker_id,
                             parent_id=parent_id,
                             attrs=dict(attrs or {})))

    def begin(self, name: str, *, worker_id: str | None = None,
              attrs: dict[str, Any] | None = None) -> Span:
        """Open a span and push it on the thread's parent stack."""
        stack = self._stack()
        span = Span(name, time.time(),
                    parent_id=stack[-1].span_id if stack else None,
                    worker_id=worker_id or self.worker_id,
                    attrs=dict(attrs or {}))
        self.add(span)
        stack.append(span)
        return span

    def finish(self, span: Span) -> Span:
        """Close a span opened with :meth:`begin` and pop the stack."""
        span.end = time.time()
        stack = self._stack()
        if span in stack:
            del stack[stack.index(span):]
        return span

    def spans(self) -> list[Span]:
        """Every span, ordered by start time (ties: insertion order)."""
        with self._lock:
            vals = list(self._spans.values())
        return sorted(vals, key=lambda s: s.start)


_current: contextvars.ContextVar[Trace | None] = \
    contextvars.ContextVar("repro_torch_obs_current_trace", default=None)


def current_trace() -> Trace | None:
    """The trace of the job executing in this context, if any."""
    return _current.get()


@contextlib.contextmanager
def use_trace(trace: Trace | None):
    """Bind ``trace`` as the current trace for the duration."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)
