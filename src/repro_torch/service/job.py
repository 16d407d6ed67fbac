"""Pipeline jobs — one submitted process list, tracked from admission to
completion.

A job's lifecycle mirrors the paper's run states plus the service-layer
extras: ``queued → checking → running(plugin i/N) → done | failed |
cancelled``.  The *chain signature* (structural identity of the process
list) is what the scheduler batches on and what the compile cache and
checkpoint store validate against.

The port's copy of ``repro.service.job``.  The broker-mode fields
(``worker_id``, ``attempt``, ``remote_results``...) are carried for the
worker slice; the in-process scheduler leaves them at their defaults.
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import json
import threading
import time
from typing import Any

import numpy as np

from ..core.framework import PluginRunner
from ..core.plugin import _is_jsonable
from ..core.process_list import ProcessList
from ..obs.trace import Trace, new_trace_id


class JobState(str, enum.Enum):
    QUEUED = "queued"
    CHECKING = "checking"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"

    def terminal(self) -> bool:
        return self in (JobState.DONE, JobState.FAILED, JobState.CANCELLED)


def chain_signature(process_list: ProcessList) -> tuple:
    """Structural identity of a process list: per-entry (class, jsonable
    params, dataset wiring).  Equal signatures ⇒ identical plugin chains
    that may share compiled programs and be gang-executed; non-jsonable
    params (inline arrays, geometry objects) are data, not structure, and
    deliberately excluded.  ``data_params`` (which dataset) and
    ``tunable_params`` (sweepable calibration values whose effect rides
    in ``jit_constants``) are excluded too — a parameter sweep's
    variants are "the same pipeline" and must gang."""
    sig = []
    for e in process_list.entries:
        skip = set(getattr(e.cls, "data_params", ())) \
            | set(getattr(e.cls, "tunable_params", ()))
        jsonable, opaque = {}, []
        for k, v in sorted(e.params.items()):
            if k in skip:
                continue
            if _is_jsonable(v):
                jsonable[k] = v
            else:
                # opaque params (callables, objects) can't be
                # fingerprinted; keep at least the qualname so swapping
                # e.g. LambdaFilter(fn=double) for fn=triple reads as a
                # different pipeline (checkpoint restore must not mix)
                opaque.append((k, getattr(v, "__qualname__",
                                          type(v).__qualname__)))
        sig.append((
            f"{e.cls.__module__}.{e.cls.__qualname__}",
            json.dumps(jsonable, sort_keys=True), tuple(opaque),
            tuple(e.in_datasets), tuple(e.out_datasets)))
    return tuple(sig)


class StreamState:
    """Server-side frame buffer for one streaming job (docs/streaming.md).

    The HTTP front end appends contiguous frame chunks under ``lock``
    and notifies ``cond``; consumers (the scheduler's driver thread, or
    a broker-mode worker polling ``GET /jobs/{id}/frames``) read any
    suffix with :meth:`fetch`.  Chunks are retained until the job is
    terminal so a lease expiry + checkpoint-resume on another worker can
    re-fetch from its restored watermark.  ``exec_lock`` serialises the
    in-process runner's pump loop against on-demand previews."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        #: serialises runner execution vs. preview (scheduler mode)
        self.exec_lock = threading.Lock()
        self.watermark = 0            # frames accepted so far
        self.eof = False
        self._starts: list[int] = []  # chunk start frames (sorted)
        self._chunks: list[np.ndarray] = []
        self._arrived: list[float] = []   # per-chunk ingest time (epoch)

    def rebase(self, start: int) -> None:
        """Start an EMPTY buffer at frame ``start``: a job resubmitted
        after a checkpoint resumes at the checkpoint's ingest watermark,
        and its producer re-sends frames from there.  Caller holds
        ``lock``."""
        if self._chunks or self.watermark:
            raise RuntimeError("rebase of a stream that already holds "
                               "frames")
        self.watermark = int(start)

    @property
    def first_frame(self) -> int:
        """The first frame the buffer holds (its rebase point).  Caller
        holds ``lock``."""
        return self._starts[0] if self._starts else self.watermark

    def append(self, frames: np.ndarray, start: int) -> int:
        """Accept a contiguous chunk; the caller validates ordering and
        holds ``lock``.  Returns the new watermark."""
        self._starts.append(start)
        self._chunks.append(frames)
        self._arrived.append(time.time())
        self.watermark = start + frames.shape[0]
        return self.watermark

    def fetch(self, start: int, max_frames: int | None = None
              ) -> tuple[np.ndarray | None, int]:
        """Frames from ``start`` (up to ``max_frames``), or (None,
        start) when nothing new has arrived.  Caller holds ``lock``."""
        if start >= self.watermark:
            return None, start
        i = bisect.bisect_right(self._starts, start) - 1
        pieces: list[np.ndarray] = []
        got = 0
        want = (self.watermark - start if max_frames is None
                else min(max_frames, self.watermark - start))
        while i < len(self._chunks) and got < want:
            c, s = self._chunks[i], self._starts[i]
            lo = max(0, start + got - s)
            hi = min(c.shape[0], lo + (want - got))
            pieces.append(c[lo:hi])
            got += hi - lo
            i += 1
        return np.concatenate(pieces, axis=0), start

    def arrival_time(self, frame: int) -> float | None:
        """Ingest timestamp of the chunk containing ``frame`` — the
        broker derives ingest lag (arrival -> consumption) from it."""
        if not self._starts or frame >= self.watermark:
            return None
        i = bisect.bisect_right(self._starts, frame) - 1
        return self._arrived[i] if i >= 0 else None

    def drop_buffers(self) -> None:
        """Release retained chunks (job terminal)."""
        with self.lock:
            self._starts, self._chunks, self._arrived = [], [], []


@dataclasses.dataclass
class Job:
    """One submitted process list, tracked from admission to completion.

    Created by :meth:`JobQueue.submit`; mutated by the scheduler as the
    job advances (``state``, ``plugin_index``, timestamps, ``runner``).
    ``snapshot()`` is the read API — everything a remote monitor needs,
    JSON-able.  The live ``runner`` (datasets, transport, profiler) is
    kept after completion so results stay retrievable until the queue's
    ``max_history`` evicts the job.
    """

    job_id: str
    process_list: ProcessList
    priority: int = 0
    seq: int = 0                         # submission order (FIFO tiebreak)
    submitted_at: float = dataclasses.field(default_factory=time.time)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    state: JobState = JobState.QUEUED
    error: str | None = None
    plugin_index: int = 0                # completed plugin steps
    n_plugins: int = 0
    resumed_from: int = 0                # >0: restored from a checkpoint
    started_at: float | None = None
    finished_at: float | None = None
    #: the live runner (datasets/transport/profiler) once checking starts
    runner: PluginRunner | None = None
    chain_sig: tuple = ()
    # -- broker-mode (worker-pull) fields -------------------------------
    #: worker currently (or last) holding this job's lease
    worker_id: str | None = None
    #: times the job has been leased; >1 means a lease expired and the
    #: job was requeued onto another worker
    attempt: int = 0
    #: a cancel arrived while a worker held the lease; the worker's next
    #: heartbeat is answered with verdict "cancelled"
    cancel_requested: bool = False
    #: dataset name -> server-readable .npy path, filled by remote
    #: workers (upload spool or shared-fs hand-off)
    remote_results: dict[str, str] = dataclasses.field(default_factory=dict)
    # -- telemetry (docs/observability.md) ------------------------------
    #: trace identity, assigned at submission (callers may supply one to
    #: correlate with an external tracing system)
    trace_id: str = ""
    #: the merged cross-process span timeline (``GET /jobs/{id}/trace``)
    trace: Trace | None = None
    #: last requeue time (lease expiry) — queue.wait spans for attempt
    #: >1 measure from here, not from submission
    requeued_at: float | None = None
    # -- streaming (docs/streaming.md) ----------------------------------
    #: spec had ``"streaming": true``: the loader dataset is fed over
    #: POST /jobs/{id}/frames instead of being complete at step 0
    streaming: bool = False
    #: server-side frame buffer (set at submission for streaming jobs)
    stream: StreamState | None = None
    #: highest frame index the executor reported consuming (broker: via
    #: the heartbeat's ``ingest_watermark``; scheduler: set directly)
    frames_consumed: int = 0
    #: frames covered by the newest uploaded preview (broker mode)
    preview_watermark: int = 0
    # -- workflow DAGs (docs/workflows.md) ------------------------------
    #: upstream job ids this job depends on (fan-in); the job is only
    #: poppable once every upstream is terminal-ok (DONE)
    after: tuple[str, ...] = ()
    #: upstream ids not yet DONE — maintained by the queue under its
    #: lock; empty ⇒ dependencies satisfied
    waiting: set[str] = dataclasses.field(default_factory=set)
    #: subset of ``after`` whose RESULTS this job consumes (output
    #: addressing); evicting such an upstream before this job runs
    #: cancels it with ``upstream_evicted``
    data_deps: tuple[str, ...] = ()
    #: machine-readable reason for a CANCELLED state
    #: ("user" | "upstream_failed" | "upstream_cancelled" |
    #: "upstream_evicted"); None while not cancelled
    cancel_reason: str | None = None

    def __post_init__(self):
        if not self.chain_sig:
            self.chain_sig = chain_signature(self.process_list)
        if not self.trace_id:
            self.trace_id = new_trace_id()
        if self.trace is None:
            self.trace = Trace(self.trace_id)
        if not self.streaming and getattr(self.process_list, "streaming",
                                          False):
            self.streaming = True
        if self.streaming and self.stream is None:
            self.stream = StreamState()
        self.after = tuple(self.after)
        self.data_deps = tuple(self.data_deps)
        if self.after and not self.waiting:
            self.waiting = set(self.after)

    def deps_ready(self) -> bool:
        """Queue-eligibility gate: every upstream job is terminal-ok.
        The queue clears ids from ``waiting`` as upstreams reach DONE
        (and cascade-cancels this job when one fails), so an empty set
        means "all dependencies satisfied"."""
        return not self.waiting

    def stream_ready(self) -> bool:
        """Queue-eligibility gate: a streaming job may only be
        dispatched/leased while it has work — unconsumed frames or the
        EOF marker.  While starved of frames it parks in the queue
        without burning a lease (docs/streaming.md)."""
        if not self.streaming:
            return True
        st = self.stream
        return st.eof or st.watermark > self.frames_consumed

    # ------------------------------------------------------------------
    @property
    def status(self) -> str:
        if self.state is JobState.RUNNING:
            return f"running(plugin {self.plugin_index}/{self.n_plugins})"
        if self.state is JobState.FAILED:
            return f"failed: {self.error}"
        return self.state.value

    @property
    def wall(self) -> float | None:
        if self.started_at is None:
            return None
        return (self.finished_at or time.time()) - self.started_at

    def snapshot(self) -> dict[str, Any]:
        """JSON-able point-in-time view of the job — what the service
        layer reports (``GET /jobs/{id}``): identity, state +
        human-readable ``status`` (``running(plugin i/N)``), priority,
        ``resumed_from`` (>0 when restored from a checkpoint),
        submission/start/finish timestamps, elapsed ``wall``, the
        failure ``error`` if any, the broker-mode ``worker_id`` /
        ``attempt`` (attempt >1 = requeued after a lease expiry), and
        the JSON-able subset of ``metadata``."""
        snap = {"job_id": self.job_id, "state": self.state.value,
                "status": self.status, "priority": self.priority,
                "plugin_index": self.plugin_index,
                "n_plugins": self.n_plugins,
                "resumed_from": self.resumed_from,
                "submitted_at": self.submitted_at,
                "started_at": self.started_at,
                "finished_at": self.finished_at, "wall": self.wall,
                "error": self.error,
                "trace_id": self.trace_id,
                "worker_id": self.worker_id, "attempt": self.attempt,
                "metadata": {k: v for k, v in self.metadata.items()
                             if _is_jsonable(v)}}
        if self.after:
            snap["after"] = list(self.after)
            snap["waiting_on"] = sorted(self.waiting)
        if self.cancel_reason is not None:
            snap["cancel_reason"] = self.cancel_reason
        if self.streaming:
            snap["streaming"] = True
            snap["ingest_watermark"] = self.stream.watermark
            snap["frames_consumed"] = self.frames_consumed
            snap["eof"] = self.stream.eof
            snap["preview_watermark"] = self.preview_watermark
        return snap
