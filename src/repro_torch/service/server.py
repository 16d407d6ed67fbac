"""HTTP front end over the JobQueue — cross-process serving.

The scheduler and checkpoint/resume layer are reachable in-process; this
module is the step that turns them into facility infrastructure in the
Nanosurveyor/Daisy sense: a remote submit/monitor interface over the
scheduler, so a beamline user can submit process lists to a pipeline
they do not run themselves.  Stdlib only (``http.server``).

Endpoints (JSON unless noted; see ``docs/service.md``):

==========================  ==========================================
``POST /jobs``              submit a spec envelope -> ``{"job_id"}``;
                            400 on validation errors, 409 on duplicate
                            active id, **429** on admission rejection
``GET /jobs``               every job's ``Job.snapshot()``
``GET /jobs/{id}``          one snapshot (``running(plugin i/N)``
                            progress, ``resumed_from``, ...)
``GET /jobs/{id}/result``   output dataset as ``.npy`` bytes
                            (``?dataset=`` selects; block-streamed)
``DELETE /jobs/{id}``       cancel a queued job (409 once dispatched)
``POST /sweeps``            expand a parameter-sweep envelope into a
                            gang of variant jobs (``docs/sweeps.md``)
``GET /sweeps[/{id}]``      sweep group status (per-variant snapshots,
                            ``best_variant`` when a metric was set)
``GET /sweeps/{id}/result`` the stacked ``.npy`` — parameter axes as
                            the new leading dimension(s)
``DELETE /sweeps/{id}``     cancel every live variant
``POST /workflows``         submit a spec-v3 DAG of process lists in
                            one atomic request (``docs/workflows.md``;
                            400 on cycles/dangling refs)
``GET /workflows[/{id}]``   workflow group status (per-node snapshots,
                            DAG edges, aggregate state)
``GET /workflows/{id}/trace``  linked trace: every node's span
                            timeline in one document
``DELETE /workflows/{id}``  cancel every live node (queued downstream
                            nodes cascade automatically)
``GET /jobs/{id}/trace``    the job's span timeline (``?format=text``
                            renders an ASCII gantt, ``?format=otlp`` an
                            OTLP/JSON export doc)
``POST /jobs/{id}/frames``  streaming ingest: one raw ``.npy`` chunk +
                            ``X-Start-Frame`` header (409 on
                            out-of-order/duplicate; docs/streaming.md)
``POST /jobs/{id}/eof``     end of acquisition for a streaming job
``GET /jobs/{id}/frames``   buffered frames from ``?start=`` on — how
                            broker-mode workers pull the stream
``GET /jobs/{id}/preview``  partial reconstruction over the frames
                            ingested so far (before EOF)
``GET /metrics``            Prometheus text exposition of the metrics
                            registry (also JSON under ``/stats``)
``GET /stats``              scheduler + compile-cache + metrics counters
``GET /plugins``            the wire-format plugin registry
``GET /events``             structured event log tail (``?since=``
                            cursor + ``?limit=``)
``GET /cluster``            per-worker scoreboard (broker mode: leases,
                            heartbeat staleness, last error, prefetch)
``GET /slo``                SLO rule states + alert lifecycle snapshot
``GET /healthz``            liveness probe; ``?ready=1`` consults the
                            SLO engine (503 while a critical rule fires)
==========================  ==========================================

Broker mode (``workers_remote=True``) serves the worker protocol
(docs/worker-protocol.md) instead of running jobs in this process:
``POST /workers``, ``POST /jobs/lease``, ``POST /jobs/{id}/progress``,
``POST /jobs/{id}/complete``, ``PUT /jobs/{id}/result``, ``GET``/``PUT
/executables/{sig}`` (the kernel library's warm pool; reads
token-authed), ``GET /executables``, ``GET /workers`` and ``GET
/cluster``.  In local mode those routes answer 409 "not serving in
broker mode", as the JAX package's local mode does.

The port's counterpart of ``repro.service.server``.  Results are tensors where their jobs left them, on the card for a
``CudaTransport``.  A result is streamed in blocks of rows, one
device-to-host copy per block, so serving a large reconstruction never
holds the whole volume in host memory; a chunk-addressed file
(``ChunkedFile``) streams chunk-row slabs straight off its file, and a
worker's ``.npy`` (broker mode) streams off the result spool.
"""
from __future__ import annotations

import hmac
import io
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import torch

from ..core.process_list import ProcessListError
from ..core.transport import (ChunkedFile, CudaTransport, ShardedTensor,
                              Transport)
from ..device import resolve_device
from ..obs.export import trace_to_otlp
from ..obs.log import EventLog
from ..obs.metrics import MetricsRegistry, register_catalogue
from ..obs.slo import SloEngine
from ..obs.trace import Span, TraceSpool, render_gantt
from .checkpoint import CheckpointStore
from .compile_cache import CompileCache
from .job import Job, JobState
from .queue import JobQueue, QueueFull
from .scheduler import (LeaseLost, PipelineScheduler, WorkerAuthError,
                        WorkerBroker)
from .sweep import SweepError, SweepGroup, SweepManager
from .wire import WireError, from_spec, registry_spec
from .workflow import WorkflowError, WorkflowGroup, WorkflowManager

#: bytes of one device-to-host copy when a result is streamed
RESULT_BLOCK_BYTES = 16 << 20

_JOB_RE = re.compile(r"^/jobs/([^/]+)$")
_RESULT_RE = re.compile(r"^/jobs/([^/]+)/result$")
_FRAMES_RE = re.compile(r"^/jobs/([^/]+)/frames$")
_EOF_RE = re.compile(r"^/jobs/([^/]+)/eof$")
_PREVIEW_RE = re.compile(r"^/jobs/([^/]+)/preview$")
_TRACE_RE = re.compile(r"^/jobs/([^/]+)/trace$")
_PROGRESS_RE = re.compile(r"^/jobs/([^/]+)/progress$")
_COMPLETE_RE = re.compile(r"^/jobs/([^/]+)/complete$")
_SWEEP_RE = re.compile(r"^/sweeps/([^/]+)$")
_SWEEP_RESULT_RE = re.compile(r"^/sweeps/([^/]+)/result$")
_WORKFLOW_RE = re.compile(r"^/workflows/([^/]+)$")
_WORKFLOW_TRACE_RE = re.compile(r"^/workflows/([^/]+)/trace$")
#: executable signatures are sha256 hex (compile_cache.executable_signature)
_EXEC_RE = re.compile(r"^/executables/([0-9a-f]{8,128})$")


class PipelineService:
    """A JobQueue + PipelineScheduler pair wrapped for HTTP serving.

    Owns the queue, the scheduler, the shared :class:`CompileCache`, and
    (optionally) a :class:`CheckpointStore`, and knows how to admit a
    wire-format spec envelope and stream results back out.  Use
    :meth:`serve` to bind the HTTP front end, or drive
    :meth:`submit_envelope`/:meth:`cancel` in-process.
    """

    def __init__(self, *,
                 device: str | torch.device = "cuda",
                 transport_factory: Callable[[Job], Transport] | None = None,
                 cost_analysis: bool = False,
                 n_workers: int = 2,
                 max_pending: int | None = 64,
                 max_history: int | None = 256,
                 checkpoints: CheckpointStore | None = None,
                 batch_identical: bool = False,
                 batch_max: int = 4,
                 compile_cache: CompileCache | None = None,
                 workers_remote: bool = False,
                 lease_ttl: float = 15.0,
                 sweep_interval: float | None = None,
                 results_dir: str | None = None,
                 executables_dir: str | None = None,
                 max_sweep_variants: int = 64,
                 token: str | None = None,
                 trace_spool: TraceSpool | str | None = None,
                 events_max: int = 2048,
                 slo_spec: dict[str, Any] | None = None,
                 slo_interval: float = 1.0):
        """Args mirror :class:`PipelineScheduler`; ``max_pending``
        bounds admission (HTTP 429 past it) and ``max_history`` bounds
        retained terminal jobs (a pruned job's result is gone — 404).

        ``device`` is where jobs compute: every submitted spec's loader
        simulates there (:func:`~.wire.from_spec`), and without a
        ``transport_factory`` every job runs on a ``CudaTransport`` on
        it, sharing the service's compile cache, with per-step cost
        profiles when ``cost_analysis`` (each distinct step measured
        once, in the shared cache; a factory's transports take their
        own).  The default is the card; it raises here on a host
        without one.

        ``token`` arms shared-secret bearer auth: every MUTATING verb
        (POST/PUT/DELETE, frame ingest included) is rejected 401 unless
        it carries ``Authorization: Bearer <token>``; reads stay open.
        ``trace_spool`` (a :class:`TraceSpool` or a directory path)
        retains terminal-job traces past ``max_history`` eviction —
        ``GET /jobs/{id}/trace`` falls back to it.

        The health plane: ``events_max`` bounds the structured
        event-log ring (``GET /events``), ``slo_spec`` overrides/extends
        the default SLO rules (:func:`~..obs.slo.rules_from_spec`), and
        ``slo_interval`` paces the background evaluator that walks
        alerts through pending → firing → resolved.

        ``workers_remote=True`` is **broker mode**: instead of
        in-process scheduler threads, detached :class:`PipelineWorker`
        processes register over HTTP and pull jobs via leases
        (``lease_ttl``/``sweep_interval``/``results_dir`` configure the
        :class:`WorkerBroker`; ``executables_dir`` roots its spool of
        framed kernel libraries, ``GET/PUT /executables/{sig}``, default
        a temp dir).  The workers compute; ``device`` is where specs are
        admitted and sweep metrics scored.  ``transport_factory``,
        ``cost_analysis``, ``n_workers``, ``checkpoints`` and the gang
        options are worker-side concerns and are ignored here.
        """
        if executables_dir is not None and not workers_remote:
            raise ValueError("executables_dir roots the broker's spool "
                             "(workers_remote=True); a local service "
                             "builds its kernels into build/kernels/")
        if transport_factory is not None and cost_analysis:
            raise ValueError("cost_analysis applies to the default "
                             "transports; a transport_factory's "
                             "transports take their own")
        self.device = resolve_device(device)
        # explicit None-check: an EMPTY CompileCache is falsy (__len__)
        if compile_cache is None:
            compile_cache = CompileCache()
        self.compile_cache = compile_cache
        if transport_factory is None and not workers_remote:
            dev, cache = self.device, compile_cache
            transport_factory = lambda job: CudaTransport(  # noqa: E731
                dev, compile_cache=cache, cost_analysis=cost_analysis)
        self.queue = JobQueue(max_pending=max_pending,
                              max_history=max_history)
        # one registry per service; the full catalogue is pre-registered
        # so /metrics is complete from the first scrape
        self.metrics = MetricsRegistry()
        register_catalogue(self.metrics)
        # the structured event log: every queue/scheduler state
        # transition lands here as one bounded JSON record
        self.events = EventLog(max_events=events_max)
        self.queue.events = self.events
        self.slo = SloEngine(self.metrics, self.events, spec=slo_spec)
        self.slo_interval = max(0.05, float(slo_interval))
        self.scheduler: PipelineScheduler | None = None
        self.broker: WorkerBroker | None = None
        if workers_remote:
            self.broker = WorkerBroker(
                self.queue, lease_ttl=lease_ttl,
                sweep_interval=sweep_interval, results_dir=results_dir,
                metrics=self.metrics, events=self.events,
                executables_dir=executables_dir)
        else:
            self.scheduler = PipelineScheduler(
                self.queue, transport_factory=transport_factory,
                n_workers=n_workers, checkpoints=checkpoints,
                batch_identical=batch_identical, batch_max=batch_max,
                compile_cache=self.compile_cache,
                metrics=self.metrics, events=self.events)
        #: what runs the jobs: the broker or the local scheduler
        self.engine = self.broker if workers_remote else self.scheduler
        self.sweeps = SweepManager(self.queue, fetch=self._variant_array,
                                   max_variants=max_sweep_variants,
                                   device=self.device)
        self.workflows = WorkflowManager(self.queue, device=self.device)
        self.token = token
        self.trace_spool = (TraceSpool(trace_spool)
                            if isinstance(trace_spool, str) else trace_spool)
        if self.trace_spool is not None:
            spool = self.trace_spool
            self.queue.add_evict_hook(
                lambda job: spool.put(job.job_id, job.trace))
        # eviction backstop: a terminal streaming job's retained frame
        # chunks must not outlive the job record
        self.queue.add_evict_hook(
            lambda job: job.stream.drop_buffers() if job.stream else None)
        self._wire_gauges()
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._slo_thread: threading.Thread | None = None
        self._slo_stop = threading.Event()

    def _wire_gauges(self) -> None:
        """Bind the callback gauges: these read live state at scrape
        time rather than being pushed on every event.  The spool, leases
        and workers belong to broker mode and read 0 in local mode, as in
        the JAX package's."""
        m = self.metrics
        m.gauge("queue.depth").set_function(self.queue.pending)
        m.gauge("queue.oldest_age_s").set_function(
            lambda: self.queue.queue_info()["oldest_pending_age"] or 0.0)
        m.gauge("compile.cache.hits").set_function(
            lambda: self.compile_cache.hits)
        m.gauge("compile.cache.misses").set_function(
            lambda: self.compile_cache.misses)
        m.gauge("compile.cache.disk.hits").set_function(
            lambda: self.compile_cache.disk_hits)
        m.gauge("compile.cache.disk.misses").set_function(
            lambda: self.compile_cache.disk_misses)
        broker = self.broker
        zero = lambda: 0                 # noqa: E731
        m.gauge("executables.spool.bytes").set_function(
            broker.executables.total_bytes if broker is not None else zero)
        m.gauge("leases.active").set_function(
            broker.n_active_leases if broker is not None else zero)
        m.gauge("workers.registered").set_function(
            broker.n_workers if broker is not None else zero)
        m.gauge("slo.firing").set_function(
            lambda: float(self.slo.n_firing()))
        m.gauge("events.head").set_function(
            lambda: float(self.events.head))

    # -- service operations (HTTP-independent) -------------------------
    def submit_envelope(self, envelope: dict[str, Any]) -> Job:
        """Admit one submission envelope::

            {"process_list": <spec v1>,   # required
             "priority": 0, "job_id": null, "metadata": {},
             "trace_id": null}            # correlate with external traces

        Deserialises the spec (:func:`~.wire.from_spec`, on the
        service's device), runs the pre-flight ``ProcessList.check()``
        so structurally broken chains are rejected before admission,
        then enqueues.

        Returns: the queued :class:`Job`.
        Raises:
            WireError / ProcessListError: invalid spec (HTTP 400).
            ValueError: duplicate active job id (HTTP 409).
            QueueFull: admission control rejected (HTTP 429).
        """
        if not isinstance(envelope, dict) or \
                "process_list" not in envelope:
            raise WireError('body must be an object with a '
                            '"process_list" spec')
        priority = envelope.get("priority", 0)
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise WireError(f"priority must be an integer, got "
                            f"{priority!r}")
        job_id = envelope.get("job_id")
        if job_id is not None and not isinstance(job_id, str):
            raise WireError(f"job_id must be a string, got {job_id!r}")
        metadata = envelope.get("metadata") or {}
        if not isinstance(metadata, dict):
            raise WireError("metadata must be an object")
        trace_id = envelope.get("trace_id")
        if trace_id is not None and not isinstance(trace_id, str):
            raise WireError(f"trace_id must be a string, got "
                            f"{trace_id!r}")
        pl = from_spec(envelope["process_list"], device=self.device)
        pl.check()
        job = self.queue.submit(pl, priority=priority, job_id=job_id,
                                metadata=metadata, trace_id=trace_id)
        self.metrics.counter("jobs.submitted").inc()
        return job

    def cancel(self, job_id: str) -> dict[str, Any]:
        """Cancel ``job_id`` if still queued — or, in broker mode, flag
        a LEASED job so its worker's next heartbeat gets a ``cancelled``
        verdict.  Returns ``{"job_id", "cancelled", "state"}`` (plus
        ``"pending": True`` for the leased case, where the terminal
        state lands at the next heartbeat); ``cancelled`` is False for a
        job already dispatched (local mode) or terminal.  Raises
        KeyError if unknown."""
        cancelled = self.queue.cancel(job_id)
        job = self.queue.job(job_id)
        out = {"job_id": job_id, "cancelled": cancelled,
               "state": job.state.value}
        # a queue-side cancel (and any dependency cascade it triggers)
        # is observed by the queue's terminal hooks — registered by both
        # scheduler and broker — so outcome metrics stay exactly-once
        if not cancelled and self.broker is not None \
                and self.broker.request_cancel(job_id):
            out.update(cancelled=True, pending=True)
        return out

    # -- streaming ingest (docs/streaming.md) ---------------------------
    def ingest_frames(self, job_id: str, frames: np.ndarray,
                      start: int) -> dict[str, Any]:
        """Accept one contiguous frame chunk (``POST /jobs/{id}/frames``)
        — :meth:`PipelineScheduler.ingest_frames` or, in broker mode,
        :meth:`WorkerBroker.ingest_frames`: out-of-order and duplicate
        chunks raise RuntimeError (HTTP 409), an unknown job KeyError
        (404)."""
        return self.engine.ingest_frames(job_id, frames, start)

    def mark_eof(self, job_id: str) -> dict[str, Any]:
        """End of acquisition (``POST /jobs/{id}/eof``)."""
        return self.engine.mark_eof(job_id)

    def preview(self, job_id: str) -> tuple[np.ndarray, int]:
        """Partial reconstruction over the frames ingested so far
        (``GET /jobs/{id}/preview``) — ``(array, frames_covered)``, from
        the live runner, or in broker mode the newest preview the worker
        uploaded.  Raises RuntimeError/ValueError (→ 409) while no
        preview can be produced yet."""
        return self.engine.preview(job_id)

    # -- parameter sweeps (docs/sweeps.md) ------------------------------
    def submit_sweep(self, envelope: dict[str, Any]) -> SweepGroup:
        """Admit one sweep envelope (``POST /sweeps``): the spec plus a
        ``sweep`` grid block, expanded into variant jobs submitted
        atomically so the gang path batches them.  See
        :meth:`SweepManager.submit` for the error contract."""
        group = self.sweeps.submit(envelope)
        self.metrics.counter("jobs.submitted").inc(group.n_variants)
        return group

    def cancel_sweep(self, sweep_id: str) -> dict[str, Any]:
        """Cancel every live variant of ``sweep_id``
        (``DELETE /sweeps/{id}``) — queued variants cancel immediately,
        leased ones at their worker's next heartbeat.  Raises KeyError
        if unknown."""
        return self.sweeps.cancel(sweep_id, self.cancel)

    # -- workflow DAGs (docs/workflows.md) ------------------------------
    def submit_workflow(self, envelope: dict[str, Any]) -> WorkflowGroup:
        """Admit one spec-v3 workflow envelope (``POST /workflows``): a
        DAG of process lists validated (cycles, dangling refs → 400)
        and admitted atomically.  See :meth:`WorkflowManager.submit`
        for the error contract."""
        group = self.workflows.submit(envelope)
        self.metrics.counter("jobs.submitted").inc(group.n_nodes)
        return group

    def cancel_workflow(self, workflow_id: str) -> dict[str, Any]:
        """Cancel every live node of ``workflow_id``
        (``DELETE /workflows/{id}``) — queued nodes cancel immediately
        and their downstream cones cascade.  Raises KeyError if
        unknown."""
        return self.workflows.cancel(workflow_id, self.cancel)

    def workflow_trace(self, workflow_id: str) -> dict[str, Any]:
        """The workflow-level linked trace (``GET
        /workflows/{id}/trace``): per-node span timelines, falling back
        to the trace spool for evicted node jobs."""
        return self.workflows.trace(workflow_id, self._job_trace_doc)

    def _job_trace_doc(self, job_id: str) -> dict[str, Any]:
        """One job's trace as a wire document — live trace when the job
        record survives, trace-spool fallback after eviction.  Raises
        KeyError when neither has it."""
        try:
            job = self.queue.job(job_id)
        except KeyError:
            rec = (self.trace_spool.get(job_id)
                   if self.trace_spool is not None else None)
            if rec is None:
                raise
            return rec
        return {"job_id": job_id, **job.trace.to_wire()}

    def _variant_array(self, job_id: str, dataset: str | None = None
                       ) -> torch.Tensor | np.ndarray:
        """One DONE variant's result where its job left it (a tensor on
        the transport's device, or on a sharded transport's slots;
        other backings read to the host; a worker's ``.npy``,
        memory-mapped) — the SweepManager's ``fetch`` hook."""
        remote = self.result_file(job_id, dataset)
        if remote is not None:
            return np.load(remote[1], mmap_mode="r")
        ds, transport = self.result_dataset(job_id, dataset)
        if isinstance(ds.backing, (torch.Tensor, ShardedTensor)):
            return ds.backing
        return np.ascontiguousarray(np.asarray(transport.read(ds)))

    # -- health plane (docs/observability.md) ---------------------------
    def readiness(self) -> tuple[int, dict[str, Any]]:
        """The degrade-aware readiness verdict
        (``GET /healthz?ready=1``): evaluate the SLO engine NOW, answer
        ``(503, detail)`` while any critical rule is firing, else
        ``(200, ok)``.  Liveness (plain ``/healthz``) never consults
        the engine."""
        self.slo.evaluate()
        critical = self.slo.critical_firing()
        if critical:
            return 503, {"ok": False, "ready": False,
                         "error": "critical SLO rule firing",
                         "firing": [r["name"] for r in critical],
                         "detail": critical,
                         "pending": self.queue.pending()}
        return 200, {"ok": True, "ready": True,
                     "pending": self.queue.pending()}

    def slo_snapshot(self) -> dict[str, Any]:
        """Fresh ``GET /slo`` payload (evaluates first, so a scrape
        never reports stale lifecycle states)."""
        self.slo.evaluate()
        return self.slo.snapshot()

    def _slo_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.slo_interval):
            self.slo.evaluate()

    def stats(self) -> dict[str, Any]:
        """Scheduler (or broker) counters + compile-cache hit rates +
        sweep and workflow counters + the metrics-registry snapshot
        (``GET /stats``)."""
        out = self.engine.stats()
        out["sweeps"] = self.sweeps.stats()
        out["workflows"] = self.workflows.stats()
        out["metrics"] = self.metrics.snapshot()
        return out

    def result_dataset(self, job_id: str, dataset: str | None = None):
        """Resolve a finished job's output dataset + its transport.

        Args:
            job_id: a DONE job still within ``max_history``.
            dataset: dataset name; default = the chain's first saver
                output (:meth:`PluginRunner.result_names`).

        Returns: ``(DataSet, Transport)``.
        Raises:
            KeyError: unknown job or unknown dataset name.
            RuntimeError: job not DONE yet, or its runner was pruned.
        """
        job = self.queue.job(job_id)
        if job.state is not JobState.DONE:
            raise RuntimeError(f"job {job_id!r} is {job.status!r}, "
                               f"not done")
        runner = job.runner
        if runner is None and job.remote_results:
            raise RuntimeError(          # broker mode: served from files
                f"job {job_id!r} ran on a remote worker; its results "
                f"are .npy files, not live datasets")
        if runner is None:
            raise RuntimeError(f"job {job_id!r} result was evicted "
                               f"(max_history)")
        name = dataset or (runner.result_names() or [None])[0]
        if name is None or name not in runner.datasets:
            raise KeyError(
                f"job {job_id!r} has no dataset {name!r} "
                f"(available: {sorted(runner.datasets)})")
        return runner.datasets[name], runner.transport

    def result_file(self, job_id: str, dataset: str | None = None
                    ) -> tuple[str, str] | None:
        """Broker-mode result lookup: ``(name, path)`` of the ``.npy`` a
        remote worker handed over for ``dataset`` (default: the first
        reported), or None when this job has no remote results
        (in-process path).

        Raises:
            KeyError: unknown job, or remote results exist but not for
                ``dataset``.
            RuntimeError: job not DONE yet.
        """
        job = self.queue.job(job_id)
        if not job.remote_results:
            return None
        if job.state is not JobState.DONE:
            raise RuntimeError(f"job {job_id!r} is {job.status!r}, "
                               f"not done")
        # dunder names (the streaming "__preview__" upload) are service
        # plumbing, never a default result
        name = dataset or next(
            (k for k in job.remote_results if not k.startswith("__")),
            next(iter(job.remote_results)))
        path = job.remote_results.get(name)
        if path is None or not os.path.exists(path):
            raise KeyError(
                f"job {job_id!r} has no result dataset {name!r} "
                f"(available: {sorted(job.remote_results)})")
        return name, path

    # -- lifecycle ------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8080,
              block: bool = False) -> tuple[str, int]:
        """Start the scheduler workers (or the broker's lease-expiry
        sweep) and the HTTP front end.

        Args:
            host/port: bind address (``port=0`` picks an ephemeral port).
            block: run ``serve_forever`` on the calling thread (CLI
                mode) instead of a daemon thread.

        Returns: the bound ``(host, port)``.
        """
        self.engine.start()
        if self._slo_thread is None:
            self._slo_stop = threading.Event()
            self._slo_thread = threading.Thread(
                target=self._slo_loop, args=(self._slo_stop,),
                name="slo-eval", daemon=True)
            self._slo_thread.start()

        class Handler(_PipelineHandler):
            service = self

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        addr = self._httpd.server_address[:2]
        if block:
            try:
                self._httpd.serve_forever()
            finally:
                self.stop()
        else:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="pipeline-http",
                daemon=True)
            self._http_thread.start()
        return addr

    def stop(self) -> None:
        """Shut down the HTTP server (if serving), the SLO evaluator and
        the scheduler workers or the broker's sweep thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        if self._slo_thread is not None:
            self._slo_stop.set()
            self._slo_thread.join(timeout=10)
            self._slo_thread = None
        self.engine.shutdown()


# ----------------------------------------------------------------------
def _npy_header(shape: tuple[int, ...], dtype) -> bytes:
    """The ``.npy`` v1 magic + header for a C-ordered array, so a result
    body can be streamed without building the array in RAM."""
    from numpy.lib import format as npy
    buf = io.BytesIO()
    npy.write_array_header_1_0(
        buf, {"descr": npy.dtype_to_descr(np.dtype(dtype)),
              "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()     # write_array_header_1_0 includes the magic


def _npy_dtype(a: torch.Tensor | ShardedTensor | np.ndarray | ChunkedFile
               ) -> np.dtype:
    if isinstance(a.dtype, torch.dtype):
        return torch.empty(0, dtype=a.dtype).numpy().dtype
    return np.dtype(a.dtype)


def _blocks(a: torch.Tensor | ShardedTensor | np.ndarray | ChunkedFile
            ) -> Iterator[bytes]:
    """C-ordered bytes of ``a`` in blocks of leading-axis rows: a tensor
    one device-to-host copy per block of about
    :data:`RESULT_BLOCK_BYTES`, a sharded tensor its slot blocks in slot
    order (each so), a chunk-addressed file one chunk-row slab at a
    time."""
    if isinstance(a, ShardedTensor):
        for t in a.leading_blocks():
            yield from _blocks(t)
        return
    if isinstance(a, ChunkedFile):
        a.flush()
        step = a.chunks[0]
        rest = tuple(slice(0, s) for s in a.shape[1:])
        for i in range(0, a.shape[0], step):
            slab = a.read((slice(i, min(i + step, a.shape[0])),) + rest)
            yield np.ascontiguousarray(slab).tobytes()
        return
    row = max(1, a[0].numel() * a.element_size()
              if isinstance(a, torch.Tensor) else a[0].nbytes)
    step = max(1, RESULT_BLOCK_BYTES // row)
    for i in range(0, a.shape[0], step):
        block = a[i:i + step]
        if isinstance(block, torch.Tensor):
            block = block.contiguous().cpu().numpy()
        yield np.ascontiguousarray(block).tobytes()


class _PipelineHandler(BaseHTTPRequestHandler):
    """Routes HTTP verbs to the bound :class:`PipelineService`."""

    service: PipelineService = None   # bound per-server in serve()
    server_version = "SavuPipeline/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet by default (tests)
        pass

    # -- helpers --------------------------------------------------------
    def _json(self, code: int, obj: Any) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, **extra) -> None:
        self._json(code, {"error": message, **extra})

    def _text(self, code: int, text: str,
              content_type: str = "text/plain; charset=utf-8") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            raise WireError("empty request body")
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise WireError(f"request body is not valid JSON: {e}")

    def _drain_body(self) -> None:
        """Consume an unread request body before replying — a keep-alive
        connection would otherwise parse the leftover bytes as the next
        request line."""
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            self.rfile.read(length)

    def _authorised(self) -> bool:
        """Shared-secret bearer check for mutating verbs.  No token
        configured = open service."""
        token = self.service.token
        if token is None:
            return True
        got = self.headers.get("Authorization") or ""
        return hmac.compare_digest(got, f"Bearer {token}")

    def _reject_unauthorised(self) -> bool:
        if self._authorised():
            return False
        self._drain_body()
        self._error(401, "missing or invalid bearer token "
                         "(Authorization: Bearer <token>)")
        return True

    def _not_broker(self) -> None:
        """A worker-protocol route: local mode has no broker."""
        self._drain_body()
        self._error(409, "not serving in broker mode (start the service "
                         "with workers_remote=True / --workers-remote)")

    def _send_file(self, path: str, headers: dict[str, str]) -> None:
        """Stream a file block-wise: O(block) RAM however big it is."""
        self.send_response(200)
        self.send_header("Content-Length", str(os.path.getsize(path)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        with open(path, "rb") as fh:
            while True:
                block = fh.read(1 << 20)
                if not block:
                    break
                self.wfile.write(block)

    def _send_array(self, arr: np.ndarray,
                    extra: dict[str, str] | None = None) -> None:
        """One in-RAM array as ``.npy`` bytes (previews, frame fetches —
        small by construction, unlike full results)."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr))
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- verbs ----------------------------------------------------------
    def do_GET(self) -> None:
        url = urlparse(self.path)
        path, query = url.path.rstrip("/") or "/", parse_qs(url.query)
        svc = self.service
        if path == "/healthz":
            # plain = cheap liveness; ?ready=1 = degrade-aware
            # readiness via the SLO engine (503 + machine-readable
            # detail while a critical rule fires)
            if (query.get("ready") or ["0"])[0] in ("1", "true"):
                return self._json(*svc.readiness())
            return self._json(200, {"ok": True,
                                    "pending": svc.queue.pending()})
        if path == "/slo":
            return self._json(200, svc.slo_snapshot())
        if path == "/events":
            try:
                since = int((query.get("since") or ["0"])[0])
                raw_limit = (query.get("limit") or [None])[0]
                limit = None if raw_limit is None else int(raw_limit)
            except ValueError:
                return self._error(400, "since/limit must be integers")
            return self._json(200, svc.events.since(since, limit=limit))
        if path == "/cluster":
            if svc.broker is None:
                return self._not_broker()
            return self._json(200, svc.broker.cluster())
        if path == "/workers":
            if svc.broker is None:
                return self._not_broker()
            return self._json(200, svc.broker.stats()["workers"])
        if path == "/stats":
            return self._json(200, svc.stats())
        if path == "/metrics":
            return self._text(200, svc.metrics.render_prometheus(),
                              content_type=MetricsRegistry.CONTENT_TYPE)
        if path == "/plugins":
            return self._json(200, registry_spec())
        if path == "/jobs":
            return self._json(200, {"jobs": svc.queue.snapshot()})
        if path == "/sweeps":
            return self._json(200, {"sweeps": svc.sweeps.snapshot_all()})
        if path == "/workflows":
            return self._json(
                200, {"workflows": svc.workflows.snapshot_all()})
        # trace regex first — _WORKFLOW_RE would also match ".../trace"
        m = _WORKFLOW_TRACE_RE.match(path)
        if m:
            workflow_id = unquote(m.group(1))
            try:
                return self._json(200, svc.workflow_trace(workflow_id))
            except KeyError:
                return self._error(
                    404, f"unknown workflow {workflow_id!r}")
        m = _WORKFLOW_RE.match(path)
        if m:
            workflow_id = unquote(m.group(1))
            try:
                return self._json(200, svc.workflows.status(workflow_id))
            except KeyError:
                return self._error(
                    404, f"unknown workflow {workflow_id!r}")
        m = _SWEEP_RESULT_RE.match(path)
        if m:
            return self._send_sweep_result(
                unquote(m.group(1)), (query.get("dataset") or [None])[0])
        m = _SWEEP_RE.match(path)
        if m:
            sweep_id = unquote(m.group(1))
            try:
                return self._json(200, svc.sweeps.status(sweep_id))
            except KeyError:
                return self._error(404, f"unknown sweep {sweep_id!r}")
        m = _EXEC_RE.match(path)
        if path == "/executables" or m:
            # token-authed even though it is a read: the hot list and the
            # libraries are worker-protocol surface (code), not a public
            # monitoring endpoint
            if self._reject_unauthorised():
                return
            if svc.broker is None:
                return self._not_broker()
            if not m:
                return self._json(200, {"hot": svc.broker.hot_executables()})
            sig = m.group(1)
            try:
                payload = svc.broker.get_executable(sig)
            except KeyError:
                return self._error(404, f"unknown executable {sig!r}")
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Executable-Sig", sig)
            self.end_headers()
            # in blocks: a library is a few MB
            for i in range(0, len(payload), 1 << 20):
                self.wfile.write(payload[i:i + (1 << 20)])
            return
        m = _TRACE_RE.match(path)
        if m:
            return self._send_trace(unquote(m.group(1)),
                                    (query.get("format") or [None])[0])
        m = _PREVIEW_RE.match(path)
        if m:
            job_id = unquote(m.group(1))
            try:
                arr, covered = svc.preview(job_id)
            except KeyError:
                return self._error(404, f"unknown job {job_id!r}")
            except (RuntimeError, ValueError) as e:
                return self._error(409, str(e))
            return self._send_array(arr,
                                    extra={"X-Watermark": str(covered)})
        m = _FRAMES_RE.match(path)
        if m:
            return self._fetch_frames(unquote(m.group(1)), query)
        m = _JOB_RE.match(path)
        if m:
            job_id = unquote(m.group(1))
            try:
                return self._json(200, svc.queue.job(job_id).snapshot())
            except KeyError:
                return self._error(404, f"unknown job {job_id!r}")
        m = _RESULT_RE.match(path)
        if m:
            return self._send_result(
                unquote(m.group(1)), (query.get("dataset") or [None])[0])
        self._error(404, f"no route for GET {path}")

    def _send_trace(self, job_id: str, fmt: str | None) -> None:
        """GET /jobs/{id}/trace: JSON, ``?format=text`` (ASCII gantt) or
        ``?format=otlp``; the trace spool answers for an evicted job."""
        svc = self.service
        try:
            job = svc.queue.job(job_id)
        except KeyError:
            rec = (svc.trace_spool.get(job_id)
                   if svc.trace_spool is not None else None)
            if rec is None:
                return self._error(404, f"unknown job {job_id!r}")
            if fmt == "text":
                spans = []
                for d in rec.get("spans", ()):
                    try:
                        spans.append(Span.from_wire(d))
                    except (KeyError, TypeError, ValueError):
                        continue
                return self._text(200, render_gantt(spans) + "\n")
            if fmt == "otlp":
                return self._json(200, trace_to_otlp(rec, {"job.id": job_id}))
            return self._json(200, rec)
        if fmt == "text":
            return self._text(200, render_gantt(job.trace.spans()) + "\n")
        if fmt == "otlp":
            return self._json(
                200, trace_to_otlp(job.trace, {"job.id": job_id}))
        return self._json(200, {"job_id": job_id, **job.trace.to_wire()})

    def do_POST(self) -> None:
        if self._reject_unauthorised():
            return
        path = urlparse(self.path).path.rstrip("/")
        m = _FRAMES_RE.match(path)
        if m:
            return self._ingest_frames(unquote(m.group(1)))
        m = _EOF_RE.match(path)
        if m:
            job_id = unquote(m.group(1))
            self._drain_body()            # EOF needs no body
            try:
                return self._json(200, self.service.mark_eof(job_id))
            except KeyError:
                return self._error(404, f"unknown job {job_id!r}")
            except RuntimeError as e:
                return self._error(409, str(e))
        if path == "/jobs":
            return self._submit()
        if path == "/sweeps":
            return self._submit_sweep()
        if path == "/workflows":
            return self._submit_workflow()
        if path == "/workers":
            return self._broker_call(
                lambda b, body: (201, b.register(body)))
        if path == "/jobs/lease":
            return self._broker_call(self._lease)
        m = _PROGRESS_RE.match(path)
        if m:
            job_id = unquote(m.group(1))
            return self._broker_call(
                lambda b, body: (200, b.progress(
                    job_id, self._worker_of(body), body)))
        m = _COMPLETE_RE.match(path)
        if m:
            job_id = unquote(m.group(1))
            return self._broker_call(
                lambda b, body: (200, b.complete(
                    job_id, self._worker_of(body), body)))
        self._drain_body()
        self._error(404, f"no route for POST {self.path}")

    # -- worker-pull protocol (broker mode) -----------------------------
    @staticmethod
    def _worker_of(body: Any) -> str:
        wid = body.get("worker_id") if isinstance(body, dict) else None
        if not isinstance(wid, str):
            raise WireError('body must carry a string "worker_id"')
        return wid

    @staticmethod
    def _lease(broker: WorkerBroker, body: Any) -> tuple[int, Any]:
        wid = _PipelineHandler._worker_of(body)
        max_jobs = body.get("max_jobs", 1)
        if not isinstance(max_jobs, int) or max_jobs < 1:
            raise WireError(f"max_jobs must be a positive int, got "
                            f"{max_jobs!r}")
        timeout = body.get("timeout", 0.0)
        if not isinstance(timeout, (int, float)) or timeout < 0 \
                or timeout > 30:
            raise WireError(f"timeout must be 0..30s, got {timeout!r}")
        prefetched = body.get("prefetched")
        if prefetched is not None and (
                not isinstance(prefetched, int) or prefetched < 0
                or isinstance(prefetched, bool)):
            raise WireError(f"prefetched must be a non-negative int, "
                            f"got {prefetched!r}")
        return 200, {"jobs": broker.lease(
            wid, max_jobs=max_jobs, timeout=float(timeout),
            secret=body.get("worker_secret"), prefetched=prefetched)}

    def _broker_call(self, fn) -> None:
        """Run one worker-protocol operation: parse the JSON body, hand
        it to ``fn(broker, body) -> (status, payload)``, map the shared
        error contract (409 no-broker/lease-lost, 404 unknown, 403 bad
        worker secret, 400 malformed)."""
        if self.service.broker is None:
            return self._not_broker()
        try:
            body = self._read_body()
            code, payload = fn(self.service.broker, body)
        except WireError as e:
            return self._error(400, str(e))
        except WorkerAuthError as e:
            return self._error(403, str(e))
        except LeaseLost as e:
            return self._error(409, str(e))
        except KeyError as e:
            return self._error(404, f"unknown {e}")
        self._json(code, payload)

    def _submit(self) -> None:
        try:
            envelope = self._read_body()
            job = self.service.submit_envelope(envelope)
        except (WireError, ProcessListError) as e:
            return self._error(400, str(e))
        except QueueFull as e:
            return self._error(429, str(e))
        except ValueError as e:           # duplicate active job id
            return self._error(409, str(e))
        self._json(201, {"job_id": job.job_id, "state": job.state.value,
                         "priority": job.priority})

    def _submit_sweep(self) -> None:
        # NB: SweepError/WireError are ValueError subclasses — they must
        # be caught before the duplicate-id ValueError below
        try:
            envelope = self._read_body()
            group = self.service.submit_sweep(envelope)
        except (SweepError, WireError, ProcessListError) as e:
            return self._error(400, str(e))
        except QueueFull as e:
            return self._error(429, str(e))
        except ValueError as e:           # duplicate active sweep/job id
            return self._error(409, str(e))
        self._json(201, {
            "sweep_id": group.sweep_id, "state": group.state(),
            "n_variants": group.n_variants, "shape": list(group.shape),
            "axes": [a.spec() for a in group.axes],
            "job_ids": [j.job_id for j in group.jobs]})

    def _submit_workflow(self) -> None:
        # NB: WorkflowError/WireError are ValueError subclasses — they
        # must be caught before the duplicate-id ValueError below
        try:
            envelope = self._read_body()
            group = self.service.submit_workflow(envelope)
        except (WorkflowError, WireError, ProcessListError) as e:
            return self._error(400, str(e))
        except QueueFull as e:
            return self._error(429, str(e))
        except ValueError as e:       # duplicate active workflow/job id
            return self._error(409, str(e))
        self._json(201, {
            "workflow_id": group.workflow_id, "state": group.state(),
            "n_nodes": group.n_nodes, "nodes": list(group.nodes),
            "job_ids": [j.job_id for j in group.jobs]})

    # -- streaming ingest (docs/streaming.md) ---------------------------
    def _ingest_frames(self, job_id: str) -> None:
        """POST /jobs/{id}/frames: raw ``.npy`` body + ``X-Start-Frame``
        header → appended to the job's stream buffer."""
        try:
            start = int(self.headers.get("X-Start-Frame", ""))
        except (TypeError, ValueError):
            self._drain_body()
            return self._error(
                400, "POST frames needs an integer X-Start-Frame header")
        length = int(self.headers.get("Content-Length") or 0)
        payload = self.rfile.read(length) if length else b""
        if not payload:
            return self._error(
                400, "empty frames body (raw .npy bytes expected)")
        try:
            frames = np.load(io.BytesIO(payload), allow_pickle=False)
        except ValueError as e:
            return self._error(400, f"frames body is not a valid .npy: "
                                    f"{e}")
        try:
            out = self.service.ingest_frames(job_id, frames, start)
        except KeyError:
            return self._error(404, f"unknown job {job_id!r}")
        except RuntimeError as e:
            return self._error(409, str(e))
        self._json(200, out)

    def _fetch_frames(self, job_id: str, query: dict) -> None:
        """GET /jobs/{id}/frames?start=&max=: the buffered stream.  204
        (with ``X-EOF``/``X-Watermark`` headers) when nothing
        at-or-after ``start`` has arrived yet."""
        svc = self.service
        try:
            job = svc.queue.job(job_id)
        except KeyError:
            return self._error(404, f"unknown job {job_id!r}")
        if not job.streaming:
            return self._error(409, f"job {job_id!r} is not a "
                                    f"streaming job")
        try:
            start = int((query.get("start") or ["0"])[0])
            raw_max = (query.get("max") or [None])[0]
            max_frames = None if raw_max is None else int(raw_max)
        except ValueError:
            return self._error(400, "start/max must be integers")
        st = job.stream
        with st.lock:
            arr, _ = st.fetch(start, max_frames)
            eof, watermark = st.eof, st.watermark
        headers = {"X-Start": str(start),
                   "X-EOF": "1" if eof else "0",
                   "X-Watermark": str(watermark)}
        if arr is None:
            self.send_response(204)
            for k, v in {**headers, "X-Count": "0"}.items():
                self.send_header(k, v)
            self.end_headers()
            return
        self._send_array(arr, extra={**headers,
                                     "X-Count": str(arr.shape[0])})

    def do_PUT(self) -> None:
        """Uploads from a leased worker (broker mode): raw ``.npy``
        result bytes to ``/jobs/{id}/result?dataset=name``, or a framed
        kernel library to ``/executables/{sig}`` — both identified by
        ``X-Worker-Id`` + ``X-Worker-Secret`` headers."""
        if self._reject_unauthorised():
            return
        url = urlparse(self.path)
        path = url.path.rstrip("/")
        m_exec, m_result = _EXEC_RE.match(path), _RESULT_RE.match(path)
        if not (m_exec or m_result):
            self._drain_body()
            return self._error(404, f"no route for PUT {self.path}")
        broker = self.service.broker
        if broker is None:
            return self._not_broker()
        worker_id = self.headers.get("X-Worker-Id")
        dataset = (parse_qs(url.query).get("dataset") or [None])[0]
        if not worker_id or (m_result and not dataset):
            self._drain_body()
            return self._error(
                400, "PUT needs an X-Worker-Id header (and ?dataset= for "
                     "a result)")
        length = int(self.headers.get("Content-Length") or 0)
        payload = self.rfile.read(length) if length else b""
        if not payload:
            return self._error(400, "empty upload body")
        secret = self.headers.get("X-Worker-Secret")
        try:
            if m_exec:
                out = broker.put_executable(worker_id, secret,
                                            m_exec.group(1), payload)
            else:
                job_id = unquote(m_result.group(1))
                broker.store_result(job_id, worker_id, dataset, payload,
                                    secret=secret)
                out = {"job_id": job_id, "dataset": dataset}
        except WireError as e:            # e.g. unsafe name, bad framing
            return self._error(400, str(e))
        except WorkerAuthError as e:
            return self._error(403, str(e))
        except LeaseLost as e:
            return self._error(409, str(e))
        except KeyError as e:
            return self._error(404, f"unknown {e}")
        self._json(200, {**out, "bytes": len(payload)})

    def do_DELETE(self) -> None:
        if self._reject_unauthorised():
            return
        self._drain_body()              # DELETEs may carry a body
        path = urlparse(self.path).path.rstrip("/")
        m = _SWEEP_RE.match(path)
        if m:
            sweep_id = unquote(m.group(1))
            try:
                return self._json(200, self.service.cancel_sweep(sweep_id))
            except KeyError:
                return self._error(404, f"unknown sweep {sweep_id!r}")
        m = _WORKFLOW_RE.match(path)
        if m:
            workflow_id = unquote(m.group(1))
            try:
                return self._json(
                    200, self.service.cancel_workflow(workflow_id))
            except KeyError:
                return self._error(
                    404, f"unknown workflow {workflow_id!r}")
        m = _JOB_RE.match(path)
        if not m:
            return self._error(404, f"no route for DELETE {self.path}")
        job_id = unquote(m.group(1))
        try:
            out = self.service.cancel(job_id)
        except KeyError:
            return self._error(404, f"unknown job {job_id!r}")
        if not out["cancelled"]:
            # dispatched or already terminal: rejected, consistently
            return self._json(409, {**out, "error":
                                    f"job is {out['state']}, not queued"})
        self._json(200, out)

    # -- result streaming -----------------------------------------------
    def _send_result(self, job_id: str, dataset: str | None) -> None:
        try:
            remote = self.service.result_file(job_id, dataset)
            if remote is not None:        # broker mode: stream the file
                return self._send_file(remote[1], {
                    "Content-Type": "application/x-npy",
                    "X-Dataset": remote[0]})
            ds, _ = self.service.result_dataset(job_id, dataset)
            backing = ds.backing
            if not isinstance(backing,
                              (torch.Tensor, ShardedTensor, ChunkedFile)):
                backing = np.asarray(ds.materialise())
        except KeyError as e:
            return self._error(404, str(e))
        except RuntimeError as e:
            return self._error(409, str(e))
        dtype = _npy_dtype(backing)
        header = _npy_header(tuple(backing.shape), dtype)
        n_bytes = int(np.prod(backing.shape)) * dtype.itemsize
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(header) + n_bytes))
        self.send_header("X-Dataset", ds.name)
        self.end_headers()
        self.wfile.write(header)
        for block in _blocks(backing):
            self.wfile.write(block)

    def _send_sweep_result(self, sweep_id: str,
                           dataset: str | None) -> None:
        """Stream the STACKED sweep result as one ``.npy``: shape
        ``(*grid_shape, *variant_shape)`` — the swept parameter axes are
        the new leading dimension(s) (Savu's tuning dimension), variants
        in C grid order, each streamed in blocks where its job left
        it."""
        svc = self.service
        try:
            group, shape, dtype, first = svc.sweeps.result_plan(
                sweep_id, dataset)
        except KeyError as e:
            return self._error(404, str(e))
        except RuntimeError as e:
            return self._error(409, str(e))
        header = _npy_header(shape, dtype)
        body = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(header) + body))
        self.send_header("X-Sweep-Id", group.sweep_id)
        self.end_headers()
        self.wfile.write(header)
        for block in _blocks(first):
            self.wfile.write(block)
        for job in group.jobs[1:]:
            arr = svc._variant_array(job.job_id, dataset)
            if tuple(arr.shape) != tuple(first.shape) or \
                    _npy_dtype(arr) != dtype:
                # headers are gone — abort the stream rather than ship
                # a silently corrupt stack (identical chains make this
                # unreachable in practice)
                raise RuntimeError(
                    f"sweep {sweep_id!r}: variant {job.job_id!r} shape/"
                    f"dtype {tuple(arr.shape)}/{_npy_dtype(arr)} != "
                    f"{tuple(first.shape)}/{dtype}")
            for block in _blocks(arr):
                self.wfile.write(block)
