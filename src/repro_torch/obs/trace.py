"""Distributed job tracing — the cross-process half of the paper's
per-process profiler (§IV.B, Fig 9).  The port's copy of
``repro.obs.trace`` (stdlib only, copied rather than imported).

Savu's MPI profiler shows what each *process* spent per plugin; a
multi-host service additionally needs to follow ONE JOB across
processes: queued at the broker, leased, executed (possibly twice,
after a lease expiry) on different workers, results handed back.  This
module is the substrate:

* a :class:`Span` is one timed operation (``queue.wait``, ``lease``,
  ``runner.prepare``, ``compile``, ``plugin.<name>.<phase>``,
  ``transport.to_device``/``to_host``, ``checkpoint.save``,
  ``result.upload``...) with a ``trace_id`` (the job), a ``span_id``
  (itself), an optional ``parent_id`` and the ``worker_id`` of the
  process that recorded it.  Timestamps are **epoch seconds**
  (``time.time()``), not a monotonic clock — spans from different
  processes must land on one comparable timeline.
* a :class:`Trace` is a thread-safe span collection for one job.  Its
  ``span()`` context manager keeps a per-thread stack so nested spans
  get ``parent_id`` links automatically; ``merge()`` folds wire spans
  in with span-id dedup, so a heartbeat that is retried (or delivered
  twice) is idempotent.
* :func:`render_gantt` draws the Fig-9-style ASCII timeline served by
  ``GET /jobs/{id}/trace?format=text``.

Workers ship finished spans to the broker piggybacked on progress
heartbeats (``take_unshipped`` / ``merge``); the "current trace" is a
:mod:`contextvars` slot so deep layers (the compile cache) can record
spans without threading a handle through every call.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import json
import os
import threading
import time
import uuid
from typing import Any, Iterable


def new_trace_id() -> str:
    """A fresh trace id (one per job/sweep-variant submission)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class Span:
    """One timed operation inside a trace.

    ``start``/``end`` are epoch seconds (``time.time()``); ``end`` is
    None while the span is open.  ``attrs`` carries JSON-able
    annotations (plugin name, phase, attempt number, outcome, flops...).
    """

    name: str
    start: float
    end: float | None = None
    trace_id: str = ""
    span_id: str = dataclasses.field(default_factory=new_span_id)
    parent_id: str | None = None
    worker_id: str | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def wall(self) -> float:
        return (self.end if self.end is not None else time.time()) \
            - self.start

    def to_wire(self) -> dict[str, Any]:
        """JSON-able wire form (heartbeat ``spans`` field, trace
        endpoint payload)."""
        out: dict[str, Any] = {"name": self.name, "start": self.start,
                               "end": self.end, "span_id": self.span_id}
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.parent_id:
            out["parent_id"] = self.parent_id
        if self.worker_id:
            out["worker_id"] = self.worker_id
        if self.attrs:
            out["attrs"] = self.attrs
        return out

    @staticmethod
    def from_wire(d: dict[str, Any]) -> "Span":
        """Inverse of :meth:`to_wire`; tolerant of missing optionals
        (raises ``KeyError``/``TypeError`` only on a span without a
        name or start)."""
        return Span(name=str(d["name"]), start=float(d["start"]),
                    end=(None if d.get("end") is None
                         else float(d["end"])),
                    trace_id=str(d.get("trace_id", "")),
                    span_id=str(d.get("span_id") or new_span_id()),
                    parent_id=d.get("parent_id") or None,
                    worker_id=d.get("worker_id") or None,
                    attrs=dict(d.get("attrs") or {}))


class Trace:
    """Thread-safe span collection for one job.

    The per-thread parent stack means ``span()`` context managers nest
    naturally: a ``plugin.x.process`` span opened inside an ``attempt``
    span records ``parent_id = attempt.span_id`` without the caller
    threading anything through.  Stacks are keyed per (trace, thread),
    so interleaving several jobs' traces on one thread (gang execution)
    keeps each job's links straight.
    """

    def __init__(self, trace_id: str | None = None,
                 worker_id: str | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.worker_id = worker_id
        self._spans: dict[str, Span] = {}      # span_id -> Span, insertion-ordered
        self._shipped: set[str] = set()
        self._lock = threading.Lock()
        self._stacks = threading.local()

    # -- recording ------------------------------------------------------
    def _stack(self) -> list[Span]:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    def add(self, span: Span) -> Span:
        """Register ``span`` (idempotent per ``span_id``); stamps the
        trace id."""
        span.trace_id = self.trace_id
        with self._lock:
            self._spans.setdefault(span.span_id, span)
        return span

    def record(self, name: str, start: float, end: float, *,
               worker_id: str | None = None,
               parent_id: str | None = None,
               attrs: dict[str, Any] | None = None) -> Span:
        """Add one already-finished span (broker-side bookkeeping:
        ``queue.wait`` and ``lease`` are only known in hindsight).
        ``parent_id`` defaults to the thread's innermost open span, so
        e.g. a ``compile`` recorded while ``plugin.x.process`` is open
        links under it."""
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1].span_id if stack else None
        return self.add(Span(name, start, end,
                             worker_id=worker_id or self.worker_id,
                             parent_id=parent_id,
                             attrs=dict(attrs or {})))

    def begin(self, name: str, *, worker_id: str | None = None,
              attrs: dict[str, Any] | None = None) -> Span:
        """Open a span (parent = the thread's current innermost span)
        and push it on the parent stack.  Close with :meth:`finish`."""
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

    @contextlib.contextmanager
    def span(self, name: str, *, worker_id: str | None = None,
             **attrs: Any):
        """Context manager: open → yield → close, with automatic
        parent links.  An exception closes the span with
        ``attrs["error"]`` set before propagating."""
        s = self.begin(name, worker_id=worker_id, attrs=attrs)
        try:
            yield s
        except BaseException as e:
            s.attrs["error"] = type(e).__name__
            raise
        finally:
            self.finish(s)

    # -- reading / shipping ---------------------------------------------
    def spans(self) -> list[Span]:
        """Every span, ordered by start time (ties: insertion order)."""
        with self._lock:
            vals = list(self._spans.values())
        return sorted(vals, key=lambda s: s.start)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def merge(self, wire_spans: Iterable[dict[str, Any]]) -> list[Span]:
        """Fold wire spans in, deduplicating on ``span_id`` — a
        re-delivered heartbeat adds nothing.  Returns only the NEWLY
        added spans (what a metrics observer should count once).
        Malformed entries are skipped, not fatal: telemetry must never
        take down the control channel."""
        new: list[Span] = []
        for d in wire_spans or ():
            try:
                span = Span.from_wire(d)
            except (KeyError, TypeError, ValueError):
                continue
            span.trace_id = self.trace_id
            with self._lock:
                if span.span_id in self._spans:
                    continue
                self._spans[span.span_id] = span
            new.append(span)
        return new

    def take_unshipped(self) -> list[Span]:
        """Finished spans not yet handed to the wire, marking them
        shipped.  The receiver dedups on span_id, so a send that fails
        mid-flight may simply be retried — :meth:`unship` restores the
        batch for the next heartbeat."""
        with self._lock:
            out = [s for s in self._spans.values()
                   if s.end is not None and s.span_id not in self._shipped]
            self._shipped.update(s.span_id for s in out)
        return out

    def unship(self, spans: Iterable[Span]) -> None:
        """Undo :meth:`take_unshipped` for a failed send."""
        with self._lock:
            self._shipped.difference_update(s.span_id for s in spans)

    def to_wire(self) -> dict[str, Any]:
        """``{"trace_id": ..., "spans": [...]}`` — the
        ``GET /jobs/{id}/trace`` payload."""
        return {"trace_id": self.trace_id,
                "spans": [s.to_wire() for s in self.spans()]}


# -- current trace (contextvar) ----------------------------------------
_current: contextvars.ContextVar[Trace | None] = \
    contextvars.ContextVar("repro_torch_obs_current_trace", default=None)


class _Tagged:
    """A trace bound by :func:`use_trace` with attributes: the spans
    recorded through it carry them (a gang step's ``gang`` size on what
    the step builds for the whole gang)."""

    def __init__(self, trace: Trace, attrs: dict[str, Any]):
        self.trace = trace
        self.tags = attrs

    def record(self, name: str, start: float, end: float, *,
               attrs: dict[str, Any] | None = None, **kw: Any) -> Span:
        return self.trace.record(name, start, end,
                                 attrs={**self.tags, **(attrs or {})}, **kw)

    def begin(self, name: str, *, attrs: dict[str, Any] | None = None,
              **kw: Any) -> Span:
        return self.trace.begin(name, attrs={**self.tags, **(attrs or {})},
                                **kw)

    def span(self, name: str, **kw: Any):
        return self.trace.span(name, **{**self.tags, **kw})

    def __getattr__(self, name: str) -> Any:
        return getattr(self.trace, name)


def current_trace() -> Trace | None:
    """The trace of the job executing on this thread/context, if any —
    how layers with no job handle (the compile cache) attach spans."""
    return _current.get()


@contextlib.contextmanager
def use_trace(trace: Trace | None, **attrs: Any):
    """Bind ``trace`` as the current trace for the duration; with
    ``attrs``, every span recorded through :func:`current_trace` carries
    them."""
    token = _current.set(_Tagged(trace, attrs) if attrs and trace is not None
                         else trace)
    try:
        yield trace
    finally:
        _current.reset(token)


# -- retention ----------------------------------------------------------
class TraceSpool:
    """Bounded on-disk ring of terminal-job traces.

    ``max_history`` pruning evicts a terminal :class:`~..service.job.Job`
    — and with it the in-RAM trace.  The service registers a queue evict
    hook that spools the trace here first, so ``GET /jobs/{id}/trace``
    keeps answering for jobs whose results are long gone.  One JSON file
    per job (filename = sha1 of the job id, so arbitrary ids stay
    filesystem-safe), written atomically (tmp + rename); past
    ``max_traces`` the oldest files (mtime) are deleted — a ring, not a
    leak.
    """

    def __init__(self, root: str, max_traces: int = 256):
        """Args:
            root: spool directory (created if missing).
            max_traces: retained trace files; oldest-by-mtime beyond
                this are evicted at each :meth:`put`.
        """
        if max_traces < 1:
            raise ValueError(f"max_traces must be >= 1, got {max_traces}")
        self.root = root
        self.max_traces = max_traces
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _path(self, job_id: str) -> str:
        digest = hashlib.sha1(job_id.encode()).hexdigest()
        return os.path.join(self.root, f"{digest}.trace.json")

    def put(self, job_id: str, trace: Trace | None) -> None:
        """Spool one job's trace (overwrites any earlier spool of the
        same id), then evict past ``max_traces``.  A None/empty trace is
        spooled too — "this job existed" beats a 404."""
        payload = {"job_id": job_id,
                   **(trace.to_wire() if trace is not None
                      else {"trace_id": "", "spans": []})}
        path = self._path(job_id)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, path)
            self._evict_locked()

    def get(self, job_id: str) -> dict[str, Any] | None:
        """The spooled wire payload (``{"job_id", "trace_id", "spans"}``)
        or None — absent and corrupt both read as "not spooled"."""
        try:
            with open(self._path(job_id)) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return None

    def _evict_locked(self) -> None:
        try:
            files = [os.path.join(self.root, f)
                     for f in os.listdir(self.root)
                     if f.endswith(".trace.json")]
        except OSError:
            return
        if len(files) <= self.max_traces:
            return
        files.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in files[:len(files) - self.max_traces]:
            try:
                os.remove(p)
            except OSError:
                pass                      # raced with another evictor

    def __len__(self) -> int:
        try:
            return sum(1 for f in os.listdir(self.root)
                       if f.endswith(".trace.json"))
        except OSError:
            return 0


# -- rendering ----------------------------------------------------------
def render_gantt(spans: Iterable[Span], width: int = 60) -> str:
    """Fig-9-style ASCII gantt over a list of (possibly multi-process)
    spans: one row per span, start-ordered, bars positioned on the
    common timeline, worker ids in the gutter.  Open spans render to
    "now"."""
    spans = sorted(spans, key=lambda s: (s.start, s.name))
    if not spans:
        return "(no spans)"
    t0 = min(s.start for s in spans)
    t1 = max((s.end if s.end is not None else time.time())
             for s in spans)
    total = max(t1 - t0, 1e-9)
    name_w = max(24, min(40, max(len(s.name) for s in spans)))
    lines = [f"{'span':<{name_w}} {'worker':<12} {'start':>8} "
             f"{'wall':>9}  timeline ({total:.3f}s total)"]
    for s in spans:
        end = s.end if s.end is not None else time.time()
        lo = int(width * (s.start - t0) / total)
        hi = int(width * (end - t0) / total)
        hi = min(max(hi, lo + 1), width)
        bar = " " * lo + "#" * (hi - lo)
        mark = "" if s.end is not None else "…"
        lines.append(
            f"{s.name[:name_w]:<{name_w}} {(s.worker_id or '-')[:12]:<12} "
            f"{s.start - t0:8.3f} {end - s.start:8.4f}s  |{bar:<{width}}|"
            f"{mark}")
    return "\n".join(lines)
