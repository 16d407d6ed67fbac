"""PipelineScheduler — many process lists, shared workers, one cache.

Savu runs one pipeline per MPI job; a facility runs *hundreds* of them a
day.  The scheduler closes that gap:

* ``n_workers`` threads pull jobs off the :class:`JobQueue` and drive
  each job's :class:`PluginRunner` through its resumable plugin steps —
  with ≥2 workers one job's host-side I/O (ChunkedFileTransport chunk
  reads, checkpoint writes) overlaps another job's device work.
* every job's transport shares one process-level
  :class:`~repro_torch.service.compile_cache.CompileCache`, so
  resubmitting an identical process list rebuilds no plugin step (the
  paper's "same pipeline, many datasets" case).
* ``batch_identical=True`` gang-schedules queued jobs whose chain
  signatures match: each plugin step executes as ONE call over all gang
  members' datasets (``CudaTransport.run_plugin_batch``: one launch of
  each hand-written kernel for the whole gang), with per-job
  calibration constants riding along.
* streaming jobs (``Job.stream`` filled by another thread) are fed and
  pumped as their frames land.
* an optional :class:`CheckpointStore` persists per-plugin completion +
  surviving datasets after every step; a killed job resubmitted with the
  same id restarts at the last finished plugin (Savu's MPI
  checkpointing).

Its second half, :class:`WorkerBroker`, feeds the same queue to
detached :class:`~repro_torch.service.worker.PipelineWorker` processes
over HTTP (broker mode: leases, heartbeats, result spools and the
kernel library's warm pool).

The port's copy of ``repro.service.scheduler``.  Without a
``transport_factory`` every job runs on an ``InMemoryTransport`` on the
card; a caller on the CPU passes a factory of CPU transports.
"""
from __future__ import annotations

import dataclasses
import hmac
import os
import re
import secrets
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from ..core.framework import PluginRunner
from ..core.plugin import _is_jsonable
from ..core.profiler import Profiler
from ..core.transport import (GangSignatureMismatch, InMemoryTransport,
                              Transport)
from ..device import resolve_device
from ..kernels.tally import tally
from ..obs.metrics import MetricsRegistry
from ..obs.trace import use_trace
from .checkpoint import CheckpointStore
from .job import Job, JobState
from .queue import JobQueue
from .wire import WireError, chain_plugin_names, to_spec


class UpstreamGone(RuntimeError):
    """A workflow job's upstream result reference cannot be resolved —
    the upstream job (or its stored result) was evicted between the
    dependency becoming ready and this job dispatching.  The job is
    cancelled with ``cancel_reason="upstream_evicted"``, mirroring the
    queue's own eviction cascade (docs/workflows.md)."""


def _upstream_ref(params: dict[str, Any]) -> tuple[str, str | None] | None:
    """The ``(from_job, dataset)`` upstream-result reference of an
    ``upstream_loader`` entry, or None when the entry needs no
    resolution (no ref, or the data/path is already materialised).
    Accepts both wire forms: split ``from_job``/``dataset`` params and
    the ``"data": {"from_job": ..., "dataset": ...}`` object."""
    data = params.get("data")
    if isinstance(data, dict) and data.get("from_job"):
        return str(data["from_job"]), data.get("dataset")
    if params.get("data") is not None or params.get("path"):
        return None
    fj = params.get("from_job")
    if fj:
        return str(fj), params.get("dataset")
    return None


def _observe_terminal(metrics: MetricsRegistry | None, job: Job,
                      events=None) -> None:
    """Fold one terminal job into the registry: outcome counter,
    end-to-end latency, and per-plugin process wall from its trace.
    Every terminal path funnels through here exactly once, so this is
    also where the structured ``job.complete`` event is emitted."""
    if job.stream is not None:
        # every terminal path funnels through here — the retained frame
        # chunks (kept for lease-expiry refetch) are no longer needed
        job.stream.drop_buffers()
    if events is not None:
        events.emit("job.complete", trace_id=job.trace_id,
                    job_id=job.job_id, worker_id=job.worker_id or "",
                    state=job.state.value, attempt=job.attempt,
                    **({"error": job.error} if job.error else {}))
    if metrics is None:
        return
    if job.state is JobState.DONE:
        metrics.counter("jobs.completed").inc()
    elif job.state is JobState.FAILED:
        metrics.counter("jobs.failed").inc()
    elif job.state is JobState.CANCELLED:
        metrics.counter("jobs.cancelled").inc()
    if job.finished_at is not None:
        metrics.histogram("job.latency.e2e").observe(
            job.finished_at - job.submitted_at)


def _observe_plugin_spans(metrics: MetricsRegistry | None,
                          spans) -> None:
    """Feed ``process``-phase plugin spans into the plugin-wall
    histograms (the aggregate plus one per plugin name).  Callers pass
    only spans seen for the FIRST time (a fresh run, or the newly-merged
    slice of a heartbeat) so nothing double-counts."""
    if metrics is None:
        return
    for s in spans:
        if not s.name.startswith("plugin.") or s.end is None:
            continue
        if s.attrs.get("phase") != "process":
            continue
        metrics.histogram("plugin.wall").observe(s.wall)
        plugin = s.attrs.get("plugin") or s.name
        metrics.histogram(f"plugin.wall.{plugin}").observe(s.wall)
        if s.attrs.get("flops"):
            metrics.gauge(f"plugin.flops.{plugin}").set(s.attrs["flops"])


def _streaming_job(queue: JobQueue, job_id: str) -> Job:
    """The job, checked to be a streaming one.  Raises KeyError (404)
    if unknown, RuntimeError (409) otherwise."""
    job = queue.job(job_id)
    if not job.streaming:
        raise RuntimeError(f"job {job_id!r} is not a streaming job "
                           f'(submit with spec v2 "streaming": true)')
    return job


def _ingest(queue: JobQueue, metrics: MetricsRegistry | None, job_id: str,
            frames: np.ndarray, start: int,
            resume: Callable[[str], int] | None = None) -> dict[str, Any]:
    """Append one contiguous frame chunk to a streaming job's buffer.
    ``start`` must equal the job's ingest watermark (the first chunk of a
    stream starts at ``resume(job_id)``, 0 without a resolver);
    out-of-order, duplicate and after-EOF chunks raise RuntimeError.
    Wakes the queue (a parked streaming job becomes runnable) and any
    in-process driver waiting on the stream."""
    job = _streaming_job(queue, job_id)
    if job.state.terminal():
        raise RuntimeError(f"job {job_id!r} is {job.state.value}; "
                           f"ingest is closed")
    frames = np.ascontiguousarray(frames)
    if frames.ndim < 1 or frames.shape[0] == 0:
        raise RuntimeError("frames chunk must have >= 1 frame on axis 0")
    st = job.stream
    with st.lock:
        if st.eof:
            raise RuntimeError(f"job {job_id!r} already got EOF; no "
                               f"more frames accepted")
        if st.watermark == 0 and resume is not None:
            st.rebase(resume(job_id))
        if start != st.watermark:
            raise RuntimeError(
                f"out-of-order ingest for job {job_id!r}: chunk starts at "
                f"frame {start} but the watermark is {st.watermark} "
                f"(duplicate or gap)")
        watermark = st.append(frames, start)
        st.cond.notify_all()
    queue.kick()
    if metrics is not None:
        metrics.counter("stream.frames.ingested").inc(int(frames.shape[0]))
    return {"job_id": job_id, "start": int(start),
            "count": int(frames.shape[0]), "watermark": watermark}


def _mark_eof(queue: JobQueue, job_id: str) -> dict[str, Any]:
    """End of acquisition: no more frames will arrive.  A second EOF on a
    live stream raises RuntimeError (409), like a duplicate chunk; EOF
    on a stream that already ran to completion succeeds (the loader
    declares its frame count, so an executor can finish the moment the
    last frame lands, ahead of the producer's EOF)."""
    job = _streaming_job(queue, job_id)
    st = job.stream
    if job.state is JobState.DONE:
        with st.lock:
            st.eof = True
            return {"job_id": job_id, "eof": True,
                    "watermark": st.watermark}
    if job.state.terminal():
        raise RuntimeError(f"job {job_id!r} is {job.state.value}; "
                           f"ingest is closed")
    with st.lock:
        if st.eof:
            raise RuntimeError(f"job {job_id!r} already got EOF")
        st.eof = True
        watermark = st.watermark
        st.cond.notify_all()
    queue.kick()
    return {"job_id": job_id, "eof": True, "watermark": watermark}


class PipelineScheduler:
    """Drives jobs popped from a :class:`JobQueue` over shared worker
    threads — reproduces the paper's §I premise (one framework, many
    simultaneous datasets) as a long-lived multi-tenant service."""

    def __init__(self, queue: JobQueue, *,
                 transport_factory: Callable[[Job], Transport] | None = None,
                 n_workers: int = 2,
                 checkpoints: CheckpointStore | None = None,
                 batch_identical: bool = False,
                 batch_max: int = 4,
                 fuse: bool = False,
                 compile_cache=None,
                 metrics: MetricsRegistry | None = None,
                 events=None):
        """Args:
            queue: the admission queue workers pull from.
            transport_factory: Job -> Transport for each dispatch
                (default: a fresh ``InMemoryTransport`` on the card
                per job; raises here on a host without one).
            n_workers: worker threads (≥2 overlaps one job's host I/O
                with another's device work; see module docstring).
            checkpoints: save after every plugin step + restore
                resubmitted job ids (None disables).
            batch_identical: gang queued jobs with matching chain
                signatures into one call per step.
            batch_max: gang size bound.
            fuse: run consecutive linear plugins as one step.
            compile_cache: held only for ``stats()`` reporting — wire
                the SAME object into the transports the factory builds.
            metrics: telemetry registry (``repro_torch.obs``) to record
                job outcomes/latencies into; None disables.
            events: structured :class:`~repro_torch.obs.log.EventLog`
                for state-transition records; None disables.
        """
        self.queue = queue
        if transport_factory is None:
            dev = resolve_device("cuda")
            transport_factory = lambda job: InMemoryTransport(dev)  # noqa: E731
        self.transport_factory = transport_factory
        self.n_workers = max(1, n_workers)
        self.checkpoints = checkpoints
        self.batch_identical = batch_identical
        self.batch_max = max(2, batch_max)
        self.fuse = fuse
        self.compile_cache = compile_cache   # held for stats reporting
        self.metrics = metrics
        self.events = events
        # terminal transitions the QUEUE performs (queue-side cancels,
        # workflow dependency cascades) are observed here — the
        # scheduler observes its own in _finish, so every terminal job
        # is counted exactly once (docs/workflows.md)
        queue.add_terminal_hook(
            lambda job: _observe_terminal(self.metrics, job,
                                          self.events))
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.jobs_done = 0
        self.jobs_failed = 0
        self.gangs_run = 0
        self.gang_fallbacks = 0      # gang steps run member by member
        self._started_at: float | None = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "PipelineScheduler":
        """Start the worker threads (idempotent).  Returns self."""
        if self._threads:
            return self
        self._started_at = time.time()
        for i in range(self.n_workers):
            # workers poll the event they were STARTED with, so a
            # shutdown always reaches this generation even after _stop
            # is re-armed for the next start()
            t = threading.Thread(target=self._worker, args=(self._stop,),
                                 name=f"pipeline-w{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def drain(self, timeout: float | None = None) -> bool:
        """Wait for every submitted job to reach a terminal state.
        Returns False on timeout (seconds; None = wait forever)."""
        return self.queue.wait_all(timeout)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the workers.  In-flight jobs finish their current run;
        queued jobs stay queued for the next ``start()``.  With
        ``wait=True`` blocks until the worker threads exit."""
        self._stop.set()
        if wait:
            for t in self._threads:
                t.join(timeout=30)
        self._threads = []
        self._stop = threading.Event()

    def stats(self) -> dict[str, Any]:
        """Aggregate counters (``GET /stats``): ``jobs_done``,
        ``jobs_failed``, ``gangs_run``, ``gang_fallbacks``, ``pending``, scheduler ``wall``
        since start, and the shared cache's ``compile_cache`` hit/miss
        counts when one was wired in."""
        out: dict[str, Any] = {
            "jobs_done": self.jobs_done, "jobs_failed": self.jobs_failed,
            "gangs_run": self.gangs_run,
            "gang_fallbacks": self.gang_fallbacks,
            "pending": self.queue.pending(),
        }
        if self._started_at is not None:
            out["wall"] = time.time() - self._started_at
        if self.compile_cache is not None:
            out["compile_cache"] = self.compile_cache.stats()
        out["queue"] = self.queue.queue_info()
        return out

    # -- worker loop ----------------------------------------------------
    def _worker(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self.batch_identical:
                jobs = self.queue.get_batch(self.batch_max, timeout=0.1)
            else:
                job = self.queue.get(timeout=0.1)
                jobs = [job] if job is not None else []
            if not jobs:
                continue
            if len(jobs) == 1:
                self._run_job(jobs[0], stop)
            else:
                self._run_gang(jobs)

    # -- solo execution -------------------------------------------------
    def _fail(self, job: Job, exc: Exception) -> None:
        job.error = f"{type(exc).__name__}: {exc}"
        job.metadata["traceback"] = traceback.format_exc()
        job.state = JobState.FAILED

    def _dispatched(self, job: Job) -> None:
        """Telemetry at dispatch: the queue.wait span (from submission,
        or from the last requeue), the queue-latency histogram, and the
        ``job.lease`` event (in-process mode the "worker" is the
        scheduler thread that claimed the job)."""
        now = job.started_at or time.time()
        waited_from = job.requeued_at or job.submitted_at
        job.trace.record("queue.wait", waited_from, now,
                         attrs={"priority": job.priority})
        if self.metrics is not None:
            self.metrics.histogram("job.latency.queue").observe(
                now - waited_from)
        if self.events is not None:
            self.events.emit("job.lease", trace_id=job.trace_id,
                             job_id=job.job_id,
                             worker_id=threading.current_thread().name,
                             priority=job.priority)

    def _drive(self, job: Job, runner: PluginRunner) -> None:
        """Step a PREPARED runner to completion (status + checkpoints)."""
        job.plugin_index = runner.current_step
        job.state = JobState.RUNNING
        while runner.step():
            job.plugin_index = runner.current_step
            if self.checkpoints is not None:
                with job.trace.span("checkpoint.save"):
                    self.checkpoints.save(job.job_id, runner)
        runner.finalise()
        job.state = JobState.DONE
        if self.checkpoints is not None:
            self.checkpoints.clear(job.job_id)

    # -- workflow upstream inputs (docs/workflows.md) -------------------
    def _upstream_array(self, from_job: str,
                        dataset: str | None) -> torch.Tensor | np.ndarray:
        """Resolve one upstream-result reference against the queue: the
        upstream job's live runner dataset (in-process runs: its tensor
        where the upstream left it, on the card for a ``CudaTransport``,
        with no copy; other backings read to the host) or its remote
        ``.npy`` (mixed deployments).  Raises UpstreamGone when the
        upstream — or its result — is no longer reachable."""
        try:
            up = self.queue.job(from_job)
        except KeyError:
            raise UpstreamGone(
                f"upstream {from_job!r} was evicted before its result "
                f"was consumed") from None
        if up.state is not JobState.DONE:
            raise UpstreamGone(
                f"upstream {from_job!r} is {up.state.value}, not done")
        if up.remote_results:
            name = dataset or next(
                (k for k in up.remote_results if not k.startswith("__")),
                None)
            path = up.remote_results.get(name) if name else None
            if path is None or not os.path.exists(path):
                raise UpstreamGone(
                    f"upstream {from_job!r} has no stored result "
                    f"{name or dataset!r}")
            return np.load(path)
        runner = up.runner
        if runner is None:
            raise UpstreamGone(
                f"upstream {from_job!r} result was evicted "
                f"(max_history)")
        name = dataset or (runner.result_names() or [None])[0]
        if name is None or name not in runner.datasets:
            raise UpstreamGone(
                f"upstream {from_job!r} has no dataset {name!r} "
                f"(available: {sorted(runner.datasets)})")
        ds = runner.datasets[name]
        if isinstance(ds.backing, torch.Tensor):
            return ds.backing
        return np.ascontiguousarray(np.asarray(runner.transport.read(ds)))

    def _resolve_upstream(self, job: Job) -> None:
        """Materialise every upstream-result reference in the job's
        chain before the runner is built: the referenced array rides in
        as the entry's ``data`` param (``upstream_loader``).  The
        resolved value is a data param — excluded from the chain
        signature — so downstream nodes still gang with other ready
        jobs."""
        for e in job.process_list.entries:
            ref = _upstream_ref(e.params)
            if ref is None:
                continue
            with job.trace.span("upstream.fetch", from_job=ref[0]):
                e.params["data"] = self._upstream_array(*ref)

    def _cancel_evicted(self, job: Job, exc: UpstreamGone) -> None:
        job.error = str(exc)
        job.state = JobState.CANCELLED
        job.cancel_reason = "upstream_evicted"

    def _run_job(self, job: Job,
                 stop: threading.Event | None = None) -> None:
        job.started_at = time.time()
        job.state = JobState.CHECKING
        self._dispatched(job)
        try:
            with use_trace(job.trace):
                self._resolve_upstream(job)
                runner = PluginRunner(job.process_list,
                                      self.transport_factory(job),
                                      profiler=Profiler(trace=job.trace),
                                      fuse=self.fuse)
                job.runner = runner
                runner.prepare()
                if self.checkpoints is not None:
                    with job.trace.span("checkpoint.restore"):
                        job.resumed_from = self.checkpoints.restore(
                            job.job_id, runner)
                job.n_plugins = runner.n_steps
                if job.streaming:
                    self._drive_stream(job, runner, stop)
                else:
                    self._drive(job, runner)
        except UpstreamGone as e:
            self._cancel_evicted(job, e)
        except Exception as e:
            self._fail(job, e)
        finally:
            self._finish([job])

    def _drive_stream(self, job: Job, runner: PluginRunner,
                      stop: threading.Event | None = None) -> None:
        """Arrival-driven execution (docs/streaming.md): feed frames
        from the job's server-side buffer as they land, pump the runner
        over each new slab, checkpoint after progress, finish once every
        group has completed.  ``stream.exec_lock`` serialises runner
        access against on-demand previews.  A shutdown that finds the
        stream starved ends the job as failed; its last checkpoint
        stays, so the same job id resubmitted resumes from it."""
        st = job.stream
        # idempotent — a checkpoint restore may already have enabled it
        # (and restored the ingested prefix + watermark)
        runner.enable_streaming()
        state = runner.stream_state()
        total, fed = state["total"], state["ingested"]
        with st.lock:
            first = st.first_frame
        if fed < first:
            raise RuntimeError(
                f"stream buffer starts at frame {first} but the runner "
                f"resumes at frame {fed}")
        job.frames_consumed = fed
        job.plugin_index = runner.current_step
        job.state = JobState.RUNNING
        while runner.current_step < runner.n_steps:
            with st.lock:
                chunk, _ = st.fetch(fed)
                eof = st.eof
                arrived = (st.arrival_time(fed) if chunk is not None
                           else None)
            if chunk is None:
                if eof and fed < total:
                    raise RuntimeError(
                        f"stream ended at frame {fed} but the loader "
                        f"declares {total} frames")
                if stop is not None and stop.is_set():
                    raise RuntimeError(
                        f"scheduler shut down mid-stream at frame "
                        f"{fed}/{total}")
                with st.cond:       # starved: wait for ingest/EOF
                    if st.watermark <= fed and not st.eof:
                        st.cond.wait(timeout=0.25)
                continue
            with st.exec_lock:
                fed = runner.feed(chunk, fed)
                if eof and fed == total:
                    runner.mark_eof()
                t0 = time.time()
                runner.pump()
            if self.metrics is not None:
                self.metrics.histogram("stream.window_latency_s") \
                    .observe(time.time() - t0)
                if arrived is not None:
                    self.metrics.histogram("stream.ingest_lag_s") \
                        .observe(max(0.0, time.time() - arrived))
            job.frames_consumed = fed
            job.plugin_index = runner.current_step
            if self.checkpoints is not None:
                with job.trace.span("checkpoint.save"):
                    self.checkpoints.save(job.job_id, runner)
        runner.finalise()
        job.state = JobState.DONE
        if self.checkpoints is not None:
            self.checkpoints.clear(job.job_id)

    # -- streaming ingest (in-process) ---------------------------------
    def ingest_frames(self, job_id: str, frames: np.ndarray,
                      start: int) -> dict[str, Any]:
        """Accept one contiguous frame chunk for a streaming job — the
        in-process counterpart of the front end's ``POST
        /jobs/{id}/frames`` (:func:`_ingest`).  A resubmitted job's
        stream starts at its checkpoint's ``stream.ingested``: the
        producer re-sends from there."""
        return _ingest(self.queue, self.metrics, job_id, frames, start,
                       resume=self._resume_watermark)

    def _resume_watermark(self, job_id: str) -> int:
        """Frames a checkpoint of ``job_id`` already ingested (0 without
        one): where a resubmitted streaming job's frames restart."""
        man = (self.checkpoints.load(job_id)
               if self.checkpoints is not None else None)
        return int(((man or {}).get("stream") or {}).get("ingested", 0))

    def mark_eof(self, job_id: str) -> dict[str, Any]:
        """End of acquisition (the front end's ``POST /jobs/{id}/eof``;
        :func:`_mark_eof`)."""
        return _mark_eof(self.queue, job_id)

    def preview(self, job_id: str) -> tuple[np.ndarray, int]:
        """Partial reconstruction over the frames consumed so far (the
        front end's ``GET /jobs/{id}/preview``): ``(array,
        frames_covered)``, computed from the live runner under
        ``stream.exec_lock``.  Raises RuntimeError/ValueError while no
        preview can be produced yet."""
        job = _streaming_job(self.queue, job_id)
        runner = job.runner
        if runner is None or not runner.streaming:
            raise RuntimeError(
                "no preview available yet (the job has not started)")
        with job.stream.exec_lock:
            arr, cut = runner.preview()
        job.preview_watermark = max(job.preview_watermark, cut)
        return arr, cut

    # -- gang execution -------------------------------------------------
    def _run_gang(self, jobs: list[Job]) -> None:
        """Identical chains from several jobs step in lockstep; each
        single-plugin step becomes one batched call.  Faults
        are isolated where possible: a job whose prepare fails is marked
        failed alone, and a batch-signature mismatch (chain signatures
        equal but runtime shapes differ, e.g. inline-scan loaders) falls
        back to per-job execution rather than failing the gang.  A job
        holding a checkpoint is restored here too (``resumed_from`` set
        like the solo path) and then driven solo — a gang would force it
        back into lockstep from step 0."""
        transport = self.transport_factory(jobs[0])
        runners: list[PluginRunner] = []
        live: list[Job] = []
        resumed: list[Job] = []
        for job in jobs:
            job.started_at = time.time()
            job.state = JobState.CHECKING
            self._dispatched(job)
            try:
                with use_trace(job.trace):
                    self._resolve_upstream(job)
                r = PluginRunner(job.process_list, transport,
                                 profiler=Profiler(trace=job.trace),
                                 fuse=self.fuse)
                job.runner = r
                r.prepare()
                if self.checkpoints is not None:
                    with job.trace.span("checkpoint.restore"):
                        job.resumed_from = self.checkpoints.restore(
                            job.job_id, r)
                job.n_plugins = r.n_steps
                if job.resumed_from:
                    resumed.append(job)
                else:
                    runners.append(r)
                    live.append(job)
            except UpstreamGone as e:
                self._cancel_evicted(job, e)
                self._finish([job])
            except Exception as e:
                self._fail(job, e)
                self._finish([job])
        for job in resumed:
            try:
                self._drive(job, job.runner)
            except Exception as e:
                self._fail(job, e)
            finally:
                self._finish([job])
        jobs = live
        if not jobs:
            return
        if len(jobs) == 1:
            job = jobs[0]
            try:
                self._drive(job, job.runner)
            except Exception as e:
                self._fail(job, e)
            finally:
                self._finish([job])
            return
        try:
            for job in jobs:
                job.state = JobState.RUNNING
            can_batch = hasattr(transport, "run_plugin_batch")
            for _ in range(runners[0].n_steps):
                groups = [r.begin_step() for r in runners]
                batched = can_batch and len(groups[0]) == 1
                # the gang step's cost, like a solo step's, is measured
                # before its timer starts
                cost = (transport.plugin_cost(*[g[0] for g in groups])
                        if batched and hasattr(transport, "plugin_cost")
                        else None)
                t0 = time.time()
                with tally() as launched:
                    if batched:
                        try:
                            transport.run_plugin_batch(
                                [g[0] for g in groups])
                        except GangSignatureMismatch as e:
                            self._gang_fallback(jobs, groups[0][0].name, e)
                            cost = None
                            for g in groups:
                                transport.run_plugin(g[0])
                    else:
                        for g in groups:
                            if len(g) > 1:
                                transport.run_fused(g)
                            else:
                                transport.run_plugin(g[0])
                t1 = time.time()
                for job, r, g in zip(jobs, runners, groups):
                    # the batched call is one step over the
                    # whole gang — each member's trace gets the shared
                    # wall, tagged with the gang size, the gang step's
                    # cost and the kernel launches it made
                    r.profiler.record(g[0].name, "process", t0, t1,
                                      gang=len(jobs), **(cost or {}),
                                      **launched.launch_attrs())
                    r.complete_step()
                    job.plugin_index = r.current_step
                    if self.checkpoints is not None:
                        with job.trace.span("checkpoint.save"):
                            self.checkpoints.save(job.job_id, r)
            for job, r in zip(jobs, runners):
                r.finalise()
                job.state = JobState.DONE
                if self.checkpoints is not None:
                    self.checkpoints.clear(job.job_id)
            with self._lock:
                self.gangs_run += 1
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            tb = traceback.format_exc()
            for job in jobs:
                if not job.state.terminal():
                    job.error = err
                    job.metadata["traceback"] = tb
                    job.state = JobState.FAILED
        finally:
            self._finish(jobs)

    def _gang_fallback(self, jobs: list[Job], plugin: str,
                       err: Exception) -> None:
        """A gang step whose members do not share one built step runs
        member by member: count it and say so in each member's events."""
        with self._lock:
            self.gang_fallbacks += 1
        if self.metrics is not None:
            self.metrics.counter("gang.fallback").inc()
        if self.events is not None:
            for job in jobs:
                self.events.emit("gang.fallback", trace_id=job.trace_id,
                                 job_id=job.job_id, plugin=plugin,
                                 gang=len(jobs), reason=str(err))

    def _finish(self, jobs: list[Job]) -> None:
        now = time.time()
        with self._lock:
            for job in jobs:
                job.finished_at = job.finished_at or now
                if job.state is JobState.DONE:
                    self.jobs_done += 1
                elif job.state is JobState.FAILED:
                    self.jobs_failed += 1
        for job in jobs:
            # in-process runs record every span exactly once, and
            # _finish sees each job exactly once — safe to fold the
            # whole trace into the plugin-wall histograms here
            _observe_terminal(self.metrics, job, self.events)
            _observe_plugin_spans(self.metrics, job.trace.spans())
        for job in jobs:
            # per-job so the queue can propagate DONE/FAILED/CANCELLED
            # into each job's downstream cone (docs/workflows.md)
            self.queue.notify_terminal(job)


# ======================================================================
# ======================================================================
# Worker-pull scheduling: the broker side of multi-host deployment.
# ======================================================================
class LeaseLost(RuntimeError):
    """The caller no longer holds the job's lease (it expired and the
    job was requeued, possibly onto another worker) — any late result
    must be discarded (HTTP 409)."""


class WorkerAuthError(RuntimeError):
    """The caller presented a missing or mismatched per-worker secret —
    a registered worker's identity may not be assumed by other sessions
    even inside token auth (HTTP 403)."""


# Clock seams.  Lease/heartbeat EXPIRY arithmetic must use the monotonic
# clock: an NTP step of the wall clock would otherwise mass-expire every
# lease (step forward) or immortalise them (step backward).  Wall time
# is kept only for display fields and trace spans.  Module-level
# indirection so tests can fake either clock independently
# (``scheduler._mono = lambda: ...``).
def _wall() -> float:
    return time.time()


def _mono() -> float:
    return time.monotonic()


#: names that may become path components (worker ids, result datasets):
#: no separators, no leading dot — "../../x" or "/etc/x" never reaches
#: os.path.join
_SAFE_NAME = re.compile(r"^[\w\-][\w.\- ]*$")


@dataclasses.dataclass
class WorkerInfo:
    """One registered worker process and its advertised capabilities."""

    worker_id: str
    #: wire plugin names the worker can execute; None = unrestricted
    plugins: frozenset[str] | None = None
    #: devices the worker computes on, as the wire's mesh shape: its
    #: card count (capacity filter)
    mesh_shape: tuple[int, ...] = (1,)
    #: the card's name (``torch.cuda.get_device_name``) or ``"cpu"``
    device: str | None = None
    #: the worker's transport (``cuda``, ``chunked``, ``inmemory``)
    transport: str | None = None
    #: largest gang the worker accepts in one lease
    max_batch: int = 1
    #: worker sees the broker's results_dir (writes results directly)
    shared_fs: bool = False
    #: worker accepts parameter-sweep variant jobs (False keeps e.g.
    #: lightweight interactive workers out of wide sweep fan-outs)
    sweeps: bool = True
    #: per-worker credential minted at registration; every subsequent
    #: lease/progress/complete/result/executable call must present it
    #: (rotated on re-registration).  Never serialised in snapshots.
    secret: str = ""
    registered_at: float = dataclasses.field(default_factory=time.time)
    last_seen: float = dataclasses.field(default_factory=time.time)
    leases_granted: int = 0
    jobs_done: int = 0
    jobs_failed: int = 0
    #: job ids currently leased to this worker
    active: set[str] = dataclasses.field(default_factory=set)
    #: the error string of the worker's most recent failed job (the
    #: cluster scoreboard's "what went wrong last" column)
    last_error: str | None = None
    #: executables the worker reported prefetching from the warm pool
    #: (piggybacked on lease requests)
    prefetched: int = 0

    def snapshot(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id,
                "plugins": (sorted(self.plugins)
                            if self.plugins is not None else None),
                "mesh_shape": list(self.mesh_shape),
                "device": self.device, "transport": self.transport,
                "max_batch": self.max_batch, "shared_fs": self.shared_fs,
                "sweeps": self.sweeps,
                "registered_at": self.registered_at,
                "last_seen": self.last_seen,
                "leases_granted": self.leases_granted,
                "jobs_done": self.jobs_done,
                "jobs_failed": self.jobs_failed,
                "active": sorted(self.active),
                "last_error": self.last_error,
                "prefetched": self.prefetched}


@dataclasses.dataclass
class _Lease:
    worker_id: str
    #: MONOTONIC-clock deadline (``_mono() + ttl``) — expiry arithmetic
    #: must survive wall-clock steps; never compare against time.time()
    expires_at: float
    #: when the lease was granted, wall clock — start of the job's
    #: ``lease`` span (display/trace only, never expiry arithmetic)
    granted_at: float = 0.0


class WorkerBroker:
    """Feeds :class:`JobQueue` jobs to detached worker *processes* —
    the multi-host half of the paper's claim that the same process list
    runs "in serial on a PC, or in parallel across a cluster": one
    queue, N ``PipelineWorker`` processes pulling from it over HTTP.

    Protocol (wire messages in ``docs/worker-protocol.md``):

    * a worker registers (:meth:`register`) with its capabilities —
      plugins available, mesh shape, max gang size, shared-fs flag;
    * it leases jobs (:meth:`lease`): the queue pop is filtered by
      those capabilities (``JobQueue.get`` with a predicate — see its
      starvation guarantee), the job is serialised back to its wire
      spec, and a lease with a TTL is recorded;
    * while running it heartbeats (:meth:`progress`) after every plugin
      step, renewing the lease and streaming ``plugin_index`` /
      ``resumed_from`` / checkpoint location back; the reply carries a
      verdict — ``ok``, ``cancelled`` (a cancel arrived mid-lease) or
      ``lost`` (the lease expired and the job was requeued);
    * it hands results over (:meth:`store_result` upload spool, or a
      shared-fs path in :meth:`complete`) and reports terminal state.

    A worker that dies silently stops heartbeating; the sweep loop
    expires its leases and requeues the jobs, which resume from their
    last checkpoint on the next capable worker (``resumed_from`` set by
    the checkpoint path — the worker restores, the broker records).
    """

    def __init__(self, queue: JobQueue, *, lease_ttl: float = 15.0,
                 sweep_interval: float | None = None,
                 results_dir: str | None = None,
                 metrics: MetricsRegistry | None = None,
                 events=None,
                 executables_dir: str | None = None,
                 executables_max_bytes: int = 512 << 20):
        """Args:
            queue: the admission queue leases are fed from.
            lease_ttl: seconds a lease survives without a heartbeat.
            sweep_interval: expiry-sweep cadence (default ``ttl / 4``,
                capped at 1s).
            results_dir: spool for worker results (uploads land here;
                shared-fs workers write into it).  Default: a fresh
                temp directory.
            metrics: telemetry registry (``repro_torch.obs``) to record job
                outcomes/latencies into; None disables.
            events: structured :class:`~repro_torch.obs.log.EventLog` for
                state-transition records (lease/park/expire/requeue/
                complete); None disables.
            executables_dir: spool for the framed kernel libraries
                workers upload (``PUT /executables/{sig}``) and fresh
                workers prefetch (warm pool).  Default: a fresh temp
                directory.
            executables_max_bytes: LRU retention bound on that spool.
        """
        self.queue = queue
        self.metrics = metrics
        self.events = events
        # exactly-once outcome attribution: terminal transitions the
        # QUEUE performs (queue-side cancels, workflow dependency
        # cascades) fire this hook; the broker observes its own
        # transitions inline (docs/workflows.md)
        queue.add_terminal_hook(
            lambda job: _observe_terminal(self.metrics, job,
                                          self.events))
        self.lease_ttl = lease_ttl
        self.sweep_interval = (sweep_interval if sweep_interval is not None
                               else min(1.0, lease_ttl / 4))
        self.results_dir = results_dir or tempfile.mkdtemp(
            prefix="pipeline-results-")
        os.makedirs(self.results_dir, exist_ok=True)
        # result-spool GC: when max_history evicts a job, its uploaded
        # .npy spool goes with it — otherwise the spool grows for the
        # broker's lifetime
        queue.add_evict_hook(self._gc_spool)
        from .compile_cache import ExecutableStore
        self.executables = ExecutableStore(
            executables_dir or tempfile.mkdtemp(prefix="pipeline-exe-"),
            max_bytes=executables_max_bytes)
        self.executables_uploaded = 0
        self.executables_served = 0
        self._workers: dict[str, WorkerInfo] = {}
        self._leases: dict[str, _Lease] = {}
        self._required: dict[str, set[str]] = {}   # job_id -> plugin names
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sweeper: threading.Thread | None = None
        self._wseq = 0
        self.jobs_done = 0
        self.jobs_failed = 0
        self.jobs_requeued = 0
        self.leases_expired = 0
        self._started_at: float | None = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "WorkerBroker":
        """Start the lease-expiry sweep thread (idempotent)."""
        if self._sweeper is not None:
            return self
        self._started_at = time.time()
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, args=(self._stop,),
            name="broker-sweep", daemon=True)
        self._sweeper.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop the sweep thread.  Leases survive (workers keep running
        their current jobs); nothing expires until the next start()."""
        self._stop.set()
        if self._sweeper is not None and wait:
            self._sweeper.join(timeout=10)
        self._sweeper = None

    # -- registration ---------------------------------------------------
    def register(self, info: dict[str, Any]) -> dict[str, Any]:
        """Admit (or refresh) a worker from its registration message::

            {"worker_id": null, "plugins": [...] | null,
             "mesh_shape": [1], "max_batch": 1, "shared_fs": false,
             "device": "NVIDIA H100 80GB HBM3", "transport": "cuda"}

        ``device`` (the card's name, or ``"cpu"``) and ``transport`` are
        optional: a JAX worker sends neither.

        Returns the reply envelope: the (possibly generated)
        ``worker_id``, a freshly minted ``worker_secret`` that every
        subsequent lease/progress/complete/result/executable call must
        present (re-registration rotates it — the old secret dies),
        the broker's ``lease_ttl``, the spool's hottest
        ``hot_executables`` signatures (the warm-pool prefetch list,
        docs/worker-protocol.md), and — for shared-fs workers — the
        ``results_dir`` to write results into.
        Raises WireError on a malformed message.
        """
        if not isinstance(info, dict):
            raise WireError("registration body must be an object")
        plugins = info.get("plugins")
        if plugins is not None and (
                not isinstance(plugins, (list, tuple))
                or not all(isinstance(p, str) for p in plugins)):
            raise WireError(f"plugins must be a list of wire names or "
                            f"null, got {plugins!r}")
        mesh_shape = info.get("mesh_shape") or [1]
        if not isinstance(mesh_shape, (list, tuple)) or \
                not all(isinstance(d, int) and d > 0 for d in mesh_shape):
            raise WireError(f"mesh_shape must be a list of positive ints, "
                            f"got {mesh_shape!r}")
        max_batch = info.get("max_batch", 1)
        if not isinstance(max_batch, int) or max_batch < 1:
            raise WireError(f"max_batch must be a positive int, got "
                            f"{max_batch!r}")
        worker_id = info.get("worker_id")
        if worker_id is not None and (
                not isinstance(worker_id, str)
                or not _SAFE_NAME.match(worker_id)):
            raise WireError(f"worker_id must be a filename-safe string "
                            f"(no path separators), got {worker_id!r}")
        device, transport = info.get("device"), info.get("transport")
        for name, v in (("device", device), ("transport", transport)):
            if v is not None and not isinstance(v, str):
                raise WireError(f"{name} must be a string or null, got "
                                f"{v!r}")
        with self._lock:
            if worker_id is None:
                self._wseq += 1
                worker_id = f"worker-{self._wseq:03d}"
            w = self._workers.get(worker_id)
            if w is None:
                w = WorkerInfo(worker_id)
                self._workers[worker_id] = w
            w.plugins = (frozenset(plugins) if plugins is not None
                         else None)
            w.mesh_shape = tuple(mesh_shape)
            w.device, w.transport = device, transport
            w.max_batch = max_batch
            w.shared_fs = bool(info.get("shared_fs", False))
            w.sweeps = bool(info.get("sweeps", True))
            w.last_seen = _wall()
            # (re-)registration mints a fresh secret: a restarting
            # worker reclaims its id without needing the old credential,
            # and the old credential stops working at the same moment
            w.secret = secrets.token_hex(16)
            reply = {"worker_id": worker_id, "lease_ttl": self.lease_ttl,
                     "worker_secret": w.secret,
                     "hot_executables": self.executables.hot()}
            if w.shared_fs:
                reply["results_dir"] = self.results_dir
            return reply

    def _check_secret_locked(self, worker_id: str,
                             secret: str | None) -> WorkerInfo:
        """The registered worker for ``worker_id`` after verifying its
        per-worker secret.  Raises KeyError (→ 404) for an unknown
        worker, WorkerAuthError (→ 403) for a missing/mismatched
        secret."""
        w = self._workers[worker_id]
        if not (isinstance(secret, str)
                and hmac.compare_digest(w.secret, secret)):
            raise WorkerAuthError(
                f"bad or missing worker_secret for {worker_id!r}")
        return w

    # -- capability matching --------------------------------------------
    def _required_plugins(self, job: Job) -> set[str]:
        need = self._required.get(job.job_id)
        if need is None:
            need = chain_plugin_names(job.process_list)
            self._required[job.job_id] = need
        return need

    def _capable(self, w: WorkerInfo, job: Job) -> bool:
        """Can ``w`` run ``job``?  Plugins: the chain's wire names must
        all be advertised (None = unrestricted).  Sweeps: a parameter-
        sweep variant (``metadata["sweep"]``) only goes to workers that
        accept sweep workloads.  Mesh: a job that asks for devices
        (``metadata["mesh_shape"]``) needs a worker whose mesh has at
        least that many."""
        if w.plugins is not None and \
                not self._required_plugins(job) <= w.plugins:
            return False
        if not w.sweeps and job.metadata.get("sweep"):
            return False
        req = job.metadata.get("mesh_shape")
        if req:
            need = 1
            for d in req:
                need *= int(d)
            have = 1
            for d in w.mesh_shape:
                have *= int(d)
            if have < need:
                return False
        return True

    # -- lease ----------------------------------------------------------
    def lease(self, worker_id: str, max_jobs: int = 1,
              timeout: float = 0.0,
              secret: str | None = None,
              prefetched: int | None = None) -> list[dict[str, Any]]:
        """Pop up to ``max_jobs`` (capped by the worker's ``max_batch``)
        capability-matching jobs and lease them to ``worker_id``.

        Returns one descriptor per job: the wire spec to execute plus
        identity/lease bookkeeping::

            {"job_id": ..., "process_list": {spec v1}, "priority": 0,
             "attempt": 1, "metadata": {...}, "lease_ttl": 15.0}

        Raises KeyError for an unregistered worker, WorkerAuthError for
        a missing/mismatched per-worker secret.  A job whose chain
        cannot be wire-serialised (in-process submission with opaque
        params) is failed loudly rather than silently starving.

        ``prefetched`` piggybacks the worker's warm-pool prefetch count
        (how many hot executables it pulled at registration) for the
        ``GET /cluster`` scoreboard.
        """
        self._expire_locked_sweep()
        with self._lock:
            w = self._check_secret_locked(worker_id, secret)
            w.last_seen = _wall()
            if isinstance(prefetched, int) and prefetched >= 0:
                w.prefetched = prefetched
            n = max(1, min(max_jobs, w.max_batch))
            pred = lambda job: self._capable(w, job)   # noqa: E731
        if n == 1:
            job = self.queue.get(timeout=timeout, predicate=pred)
            jobs = [job] if job is not None else []
        else:
            jobs = self.queue.get_batch(n, timeout=timeout, predicate=pred)
        out = []
        now = _wall()                    # display / span timestamps
        now_m = _mono()                  # lease-deadline arithmetic
        with self._lock:
            shared_fs = w.shared_fs
        for job in jobs:
            try:
                spec = to_spec(job.process_list)
                self._resolve_upstream_spec(job, spec, shared_fs)
            except UpstreamGone as e:
                job.error = str(e)
                job.state = JobState.CANCELLED
                job.cancel_reason = "upstream_evicted"
                job.finished_at = time.time()
                with self._lock:
                    self._required.pop(job.job_id, None)
                _observe_terminal(self.metrics, job, self.events)
                self.queue.notify_terminal(job)
                continue
            except WireError as e:
                job.error = f"WireError: {e}"
                job.state = JobState.FAILED
                job.finished_at = time.time()
                with self._lock:
                    self.jobs_failed += 1
                    self._required.pop(job.job_id, None)
                _observe_terminal(self.metrics, job, self.events)
                self.queue.notify_terminal(job)
                continue
            with self._lock:
                job.worker_id = worker_id
                job.attempt += 1
                job.started_at = job.started_at or now
                self._leases[job.job_id] = _Lease(
                    worker_id, now_m + self.lease_ttl, granted_at=now)
                w.leases_granted += 1
                w.active.add(job.job_id)
            # the broker records the queue-side spans; the worker adds
            # the execution spans via heartbeats (one merged timeline)
            waited_from = job.requeued_at or job.submitted_at
            job.trace.record("queue.wait", waited_from, now,
                             attrs={"priority": job.priority,
                                    "attempt": job.attempt})
            if self.metrics is not None:
                self.metrics.histogram("job.latency.queue").observe(
                    now - waited_from)
            if self.events is not None:
                self.events.emit("job.lease", trace_id=job.trace_id,
                                 job_id=job.job_id, worker_id=worker_id,
                                 attempt=job.attempt,
                                 priority=job.priority)
            out.append({
                "job_id": job.job_id, "process_list": spec,
                "priority": job.priority, "attempt": job.attempt,
                "trace_id": job.trace_id,
                "metadata": {k: v for k, v in job.metadata.items()
                             if _is_jsonable(v)},
                "lease_ttl": self.lease_ttl})
        return out

    # -- workflow upstream inputs (docs/workflows.md) -------------------
    def _resolve_upstream_spec(self, job: Job, spec: dict[str, Any],
                               shared_fs: bool) -> None:
        """Rewrite upstream-result references in the SERIALISED spec at
        lease time.  Shared-fs workers get the broker-side ``.npy``
        path spliced in (zero-copy hand-off); remote workers keep the
        ref and fetch it over ``GET /jobs/{id}/result``.  Only the
        descriptor's spec dict is touched — never ``job.process_list``
        — so a lease expiry + re-lease to a differently-capable worker
        re-resolves from scratch.  Raises UpstreamGone when the
        upstream result is no longer reachable."""
        for ent in spec.get("plugins", ()):
            params = ent.get("params")
            if not isinstance(params, dict):
                continue
            ref = _upstream_ref(params)
            if ref is None:
                continue
            from_job, dataset = ref
            try:
                up = self.queue.job(from_job)
            except KeyError:
                raise UpstreamGone(
                    f"upstream {from_job!r} was evicted before its "
                    f"result was consumed") from None
            if up.state is not JobState.DONE:
                raise UpstreamGone(
                    f"upstream {from_job!r} is {up.state.value}, "
                    f"not done")
            name = dataset or next(
                (k for k in up.remote_results if not k.startswith("__")),
                None)
            path = up.remote_results.get(name) if name else None
            if path is None or not os.path.exists(path):
                raise UpstreamGone(
                    f"upstream {from_job!r} has no stored result "
                    f"{name or dataset!r}")
            params = dict(params)
            if shared_fs:
                params.pop("data", None)
                params["path"] = path
                params["from_job"] = None
            else:
                # normalise to the split form the worker resolves over
                # HTTP (GET /jobs/{from_job}/result?dataset=...)
                params.pop("data", None)
                params["from_job"] = from_job
                params["dataset"] = name
            ent["params"] = params

    # -- heartbeat / progress -------------------------------------------
    def progress(self, job_id: str, worker_id: str,
                 body: dict[str, Any] | None = None) -> dict[str, Any]:
        """Heartbeat + per-plugin progress from the leased worker.

        Renews the lease and folds ``plugin_index`` / ``n_plugins`` /
        ``resumed_from`` / ``checkpoint`` (a location string) into the
        job's snapshot.  The verdict in the reply is the control
        channel back to the worker:

        * ``"ok"`` — keep going (lease renewed);
        * ``"cancelled"`` — a cancel arrived while the worker held the
          lease; the job is now terminal, stop and discard;
        * ``"lost"`` — the lease expired (or another worker owns the
          job after a requeue); stop, the job is no longer yours.
          Exactly one owner survives an expiry race: the requeue
          happens under the broker lock, and a stale owner can never
          match the new lease's ``worker_id``.

        Raises KeyError for an unknown job, WorkerAuthError when a
        REGISTERED worker's secret is missing/mismatched (an
        unregistered worker_id falls through to the lease checks and is
        answered ``lost`` as before — there is no credential to verify).
        """
        body = body or {}
        job = self.queue.job(job_id)
        now = time.time()                # span timestamps (epoch)
        now_m = _mono()                  # lease-expiry arithmetic
        # fold piggybacked spans into the job's trace FIRST, whatever
        # the verdict — a worker about to be told "lost" still carries
        # real history from its attempt (span-id dedup makes redelivery
        # idempotent), and the killed-worker spans the resume timeline
        # needs arrive exactly this way
        new_spans = job.trace.merge(body.get("spans") or [])
        _observe_plugin_spans(self.metrics, new_spans)
        with self._lock:
            if worker_id in self._workers:
                self._check_secret_locked(worker_id,
                                          body.get("worker_secret"))
            lease = self._leases.get(job_id)
            if lease is None or lease.worker_id != worker_id:
                return {"verdict": "lost"}
            w = self._workers.get(worker_id)
            if w is not None:
                w.last_seen = now
            if now_m > lease.expires_at:
                # expired but not yet swept: reject the heartbeat and
                # requeue NOW so the job lands on a live worker (the
                # requeue may CANCEL a cancel-flagged job — terminal —
                # so fall through to notify_terminal below)
                self._end_lease_locked(job, lease, "lost", now)
                self._drop_lease_locked(job_id, worker_id)
                self._requeue_locked(job)
                verdict = {"verdict": "lost"}
            elif job.cancel_requested or job.state is JobState.CANCELLED:
                self._end_lease_locked(job, lease, "cancelled", now)
                self._drop_lease_locked(job_id, worker_id)
                if not job.state.terminal():
                    job.state = JobState.CANCELLED
                    job.cancel_reason = job.cancel_reason or "user"
                    job.finished_at = now
                    _observe_terminal(self.metrics, job, self.events)
                verdict = {"verdict": "cancelled"}
            else:
                lease.expires_at = now_m + self.lease_ttl
                if isinstance(body.get("plugin_index"), int):
                    # a bare renewal (no fields) keeps the lease alive
                    # without claiming execution started — batch-leased
                    # jobs waiting their turn stay "checking"
                    job.state = JobState.RUNNING
                    job.plugin_index = body["plugin_index"]
                if isinstance(body.get("n_plugins"), int):
                    job.n_plugins = body["n_plugins"]
                if isinstance(body.get("resumed_from"), int):
                    job.resumed_from = max(job.resumed_from,
                                           body["resumed_from"])
                if isinstance(body.get("checkpoint"), str):
                    job.metadata["checkpoint"] = body["checkpoint"]
                if isinstance(body.get("ingest_watermark"), int) and \
                        job.stream is not None:
                    self._fold_ingest_locked(job,
                                             body["ingest_watermark"], now)
                if isinstance(body.get("preview_watermark"), int):
                    job.preview_watermark = max(job.preview_watermark,
                                                body["preview_watermark"])
                if self.metrics is not None and isinstance(
                        body.get("window_latency"), (int, float)) and \
                        not isinstance(body.get("window_latency"), bool):
                    # worker-side pump wall for the freshest streamed
                    # window — transient on the heartbeat (shipped once,
                    # never re-posted), so stream.window_latency_s is
                    # read in broker mode as in scheduler mode
                    self.metrics.histogram("stream.window_latency_s") \
                        .observe(max(0.0, float(body["window_latency"])))
                if body.get("park") and job.streaming:
                    # starved streaming worker: hand the job back to the
                    # queue (a checkpoint was just reported) so the
                    # worker slot frees up instead of burning the lease
                    # polling.  stream_ready() keeps it unleasable until
                    # frames or EOF arrive.
                    self._end_lease_locked(job, lease, "parked", now)
                    self._drop_lease_locked(job_id, worker_id)
                    if self.metrics is not None:
                        self.metrics.counter("jobs.parked").inc()
                    if self.events is not None:
                        self.events.emit(
                            "job.park", trace_id=job.trace_id,
                            job_id=job_id, worker_id=worker_id,
                            frames_consumed=job.frames_consumed)
                    self.queue.requeue(job)
                    return {"verdict": "parked"}
                return {"verdict": "ok", "lease_ttl": self.lease_ttl}
        self.queue.notify_terminal(job)
        return verdict

    def _fold_ingest_locked(self, job: Job, watermark: int,
                            now: float) -> None:
        """Heartbeat carried the worker's consumption watermark: advance
        ``frames_consumed`` (monotone) and derive the ingest-lag sample
        (newest consumed frame's arrival -> this heartbeat)."""
        prev = job.frames_consumed
        job.frames_consumed = max(prev, watermark)
        if self.metrics is not None and watermark > prev:
            with job.stream.lock:
                arrived = job.stream.arrival_time(watermark - 1)
            if arrived is not None:
                self.metrics.histogram("stream.ingest_lag_s").observe(
                    max(0.0, now - arrived))

    # -- streaming ingest (docs/streaming.md) ---------------------------
    def ingest_frames(self, job_id: str, frames: np.ndarray,
                      start: int) -> dict[str, Any]:
        """Buffer one frame chunk for the job's worker to pull
        (``GET /jobs/{id}/frames``); :func:`_ingest`.  The buffer keeps
        every frame until the job ends, so a re-leased job's worker
        refetches from its restored watermark."""
        return _ingest(self.queue, self.metrics, job_id, frames, start)

    def mark_eof(self, job_id: str) -> dict[str, Any]:
        """End of acquisition (:func:`_mark_eof`)."""
        return _mark_eof(self.queue, job_id)

    def preview(self, job_id: str) -> tuple[np.ndarray, int]:
        """The newest partial reconstruction the worker uploaded (the
        ``__preview__`` result) and the frames it covers.  Raises
        RuntimeError (409) until one has arrived."""
        job = _streaming_job(self.queue, job_id)
        with self._lock:
            path = job.remote_results.get("__preview__")
        if path is None or not os.path.exists(path):
            raise RuntimeError("no preview available yet (the worker has "
                               "not uploaded one)")
        return np.load(path), job.preview_watermark

    # -- results --------------------------------------------------------
    def _spool_dir(self, job_id: str) -> str:
        return os.path.join(self.results_dir,
                            job_id.replace(os.sep, "_").replace("..", "_"))

    def _job_spool(self, job_id: str) -> str:
        d = self._spool_dir(job_id)
        os.makedirs(d, exist_ok=True)
        return d

    def _gc_spool(self, job: Job) -> None:
        """``JobQueue`` evict hook: delete the evicted job's result
        spool (uploaded AND shared-fs files live under
        ``results_dir/<job_id>``).  The job is already removed — its
        result was going to 404 anyway; now the bytes go too."""
        shutil.rmtree(self._spool_dir(job.job_id), ignore_errors=True)
        job.remote_results.clear()

    def store_result(self, job_id: str, worker_id: str, dataset: str,
                     payload: bytes, secret: str | None = None) -> str:
        """Spool one uploaded result dataset (raw ``.npy`` bytes) for
        ``GET /jobs/{id}/result`` to stream later.  Only the current
        lease holder may upload — a worker that lost its lease gets
        :class:`LeaseLost` and must discard its copy; a registered
        worker with a bad secret gets :class:`WorkerAuthError`."""
        if not _SAFE_NAME.match(dataset):
            # the name becomes a path component under results_dir —
            # refuse separators/dot-leading names, never traverse out
            raise WireError(f"dataset must be a filename-safe name, "
                            f"got {dataset!r}")
        with self._lock:
            if worker_id in self._workers:
                self._check_secret_locked(worker_id, secret)
            lease = self._leases.get(job_id)
            if lease is None or lease.worker_id != worker_id:
                raise LeaseLost(f"worker {worker_id!r} no longer holds "
                                f"the lease on job {job_id!r}")
        path = os.path.join(self._job_spool(job_id), f"{dataset}.npy")
        tmp = f"{path}.{worker_id}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
        job = self.queue.job(job_id)
        with self._lock:
            job.remote_results[dataset] = path
        return path

    # -- executable warm pool (docs/worker-protocol.md) -----------------
    def put_executable(self, worker_id: str, secret: str | None,
                       sig: str, payload: bytes) -> dict[str, Any]:
        """Accept one framed kernel library a worker just built
        (``PUT /executables/{sig}``).  Only registered workers with a
        valid secret may upload (KeyError → 404, WorkerAuthError →
        403); only framed payloads enter the spool (WireError → 400).
        """
        with self._lock:
            self._check_secret_locked(worker_id, secret)
        if not self.executables.put_bytes(sig, payload):
            if self.metrics is not None:
                self.metrics.counter("executables.rejected").inc()
            raise WireError(f"rejected executable payload for {sig!r} "
                            f"(bad signature or framing)")
        with self._lock:
            self.executables_uploaded += 1
        if self.metrics is not None:
            self.metrics.counter("executables.uploaded").inc()
        return {"sig": sig, "stored": True}

    def get_executable(self, sig: str) -> bytes:
        """The raw payload for one signature (``GET /executables/
        {sig}``).  Raises KeyError when absent.  Each fetch counts a
        use, which is exactly the heat signal :meth:`register`'s
        ``hot_executables`` list ranks by."""
        payload = self.executables.get_bytes(sig)
        if payload is None:
            raise KeyError(sig)
        with self._lock:
            self.executables_served += 1
        if self.metrics is not None:
            self.metrics.counter("executables.served").inc()
        return payload

    def hot_executables(self, n: int = 8) -> list[str]:
        """The spool's hottest signatures (``GET /executables``)."""
        return self.executables.hot(n)

    def complete(self, job_id: str, worker_id: str,
                 body: dict[str, Any]) -> dict[str, Any]:
        """Terminal report from the lease holder::

            {"state": "done" | "failed", "error": null,
             "results": {"recon": {"path": "/shared/.../recon.npy"}}}

        ``results`` paths are the shared-fs hand-off (the worker wrote
        the ``.npy`` under ``results_dir`` where the broker can read
        it — paths outside ``results_dir`` are refused);
        uploaded datasets were already spooled via
        :meth:`store_result`.  Raises :class:`LeaseLost` if the lease
        is gone — the job was requeued, this worker's outcome is void.
        """
        job = self.queue.job(job_id)
        state = body.get("state")
        if state not in ("done", "failed"):
            raise WireError(f'complete state must be "done" or "failed", '
                            f'got {state!r}')
        # keep the worker's final span flush even if the lease check
        # below raises LeaseLost — a late completion is void as an
        # OUTCOME, but its spans are real history on the timeline
        new_spans = job.trace.merge(body.get("spans") or [])
        _observe_plugin_spans(self.metrics, new_spans)
        results = body.get("results") or {}
        if not isinstance(results, dict):
            raise WireError("results must be an object")
        # validate BEFORE touching any state: a shared-fs hand-off may
        # only name paths inside results_dir — the broker must never be
        # talked into streaming an arbitrary server file to clients
        root = os.path.realpath(self.results_dir)
        accepted: dict[str, str] = {}
        for name, ent in results.items():
            path = ent.get("path") if isinstance(ent, dict) else None
            if not path:
                continue
            real = os.path.realpath(path)
            if not real.startswith(root + os.sep):
                raise WireError(f"result path for {name!r} is outside "
                                f"the broker results_dir")
            if os.path.exists(real):
                accepted[name] = real
        now = time.time()
        with self._lock:
            if worker_id in self._workers:
                self._check_secret_locked(worker_id,
                                          body.get("worker_secret"))
            lease = self._leases.get(job_id)
            if lease is None or lease.worker_id != worker_id or \
                    _mono() > lease.expires_at:
                raise LeaseLost(f"worker {worker_id!r} no longer holds "
                                f"the lease on job {job_id!r}")
            self._end_lease_locked(job, lease, state, now)
            self._drop_lease_locked(job_id, worker_id)
            w = self._workers.get(worker_id)
            job.remote_results.update(accepted)
            if isinstance(body.get("plugin_index"), int):
                job.plugin_index = body["plugin_index"]
            if isinstance(body.get("n_plugins"), int):
                job.n_plugins = body["n_plugins"]
            if state == "done":
                job.state = JobState.DONE
                self.jobs_done += 1
                if w is not None:
                    w.jobs_done += 1
            else:
                job.error = str(body.get("error") or "worker failure")
                job.state = JobState.FAILED
                self.jobs_failed += 1
                if w is not None:
                    w.jobs_failed += 1
                    w.last_error = job.error
            job.finished_at = now
            self._required.pop(job_id, None)
        _observe_terminal(self.metrics, job, self.events)
        self.queue.notify_terminal(job)
        return {"job_id": job_id, "state": job.state.value}

    # -- cancellation ---------------------------------------------------
    def request_cancel(self, job_id: str) -> bool:
        """Cancel a LEASED job cooperatively: flag it so the worker's
        next heartbeat is answered ``cancelled``.  Returns True if the
        job is currently leased (cancel pending), False otherwise."""
        with self._lock:
            lease = self._leases.get(job_id)
            if lease is None:
                return False
            try:
                job = self.queue.job(job_id)
            except KeyError:
                return False
            if job.state.terminal():
                return False
            job.cancel_requested = True
            return True

    # -- expiry ---------------------------------------------------------
    def _end_lease_locked(self, job: Job, lease: _Lease, outcome: str,
                          now: float) -> None:
        """Record the closing ``lease`` span: one per attempt, covering
        grant → end, tagged with the holding worker and how it ended
        (``done``/``failed``/``cancelled``/``lost``/``expired``)."""
        job.trace.record("lease", lease.granted_at or job.submitted_at,
                         now, worker_id=lease.worker_id,
                         attrs={"outcome": outcome,
                                "attempt": job.attempt})

    def _drop_lease_locked(self, job_id: str, worker_id: str) -> None:
        self._leases.pop(job_id, None)
        w = self._workers.get(worker_id)
        if w is not None:
            w.active.discard(job_id)

    def _requeue_locked(self, job: Job) -> None:
        self.leases_expired += 1
        if self.metrics is not None:
            self.metrics.counter("lease.expired").inc()
        if self.events is not None:
            # the single choke point for BOTH expiry paths (heartbeat-
            # detected and sweep-detected) — exactly one event per
            # expired lease
            self.events.emit("lease.expire", trace_id=job.trace_id,
                             job_id=job.job_id,
                             worker_id=job.worker_id or "",
                             attempt=job.attempt)
        if job.cancel_requested and not job.state.terminal():
            job.state = JobState.CANCELLED
            job.cancel_reason = job.cancel_reason or "user"
            job.finished_at = time.time()
            _observe_terminal(self.metrics, job, self.events)
            return
        if self.queue.requeue(job):
            self.jobs_requeued += 1
            if self.metrics is not None:
                self.metrics.counter("jobs.requeued").inc()
            if self.events is not None:
                self.events.emit("job.requeue", trace_id=job.trace_id,
                                 job_id=job.job_id,
                                 worker_id=job.worker_id or "",
                                 attempt=job.attempt)

    def _expire_locked_sweep(self) -> None:
        """Requeue every job whose lease expired (dead worker), and
        prune the required-plugins cache of jobs that went terminal via
        any path (cancel, failure, eviction) — the cache must not grow
        for the broker's lifetime."""
        now = time.time()                # span timestamps
        now_m = _mono()                  # expiry arithmetic
        touched: list[Job] = []
        with self._lock:
            expired = [(jid, ls) for jid, ls in self._leases.items()
                       if now_m > ls.expires_at]
            for jid, ls in expired:
                self._drop_lease_locked(jid, ls.worker_id)
                try:
                    job = self.queue.job(jid)
                except KeyError:
                    continue
                self._end_lease_locked(job, ls, "expired", now)
                if not job.state.terminal():
                    self._requeue_locked(job)
                touched.append(job)
            for jid in list(self._required):
                try:
                    if self.queue.job(jid).state.terminal():
                        del self._required[jid]
                except KeyError:
                    del self._required[jid]
        for job in touched:
            # per-job: a cancel-flagged expiry went CANCELLED and must
            # cascade into its downstream cone; plain requeues are
            # non-terminal and only wake capacity waiters
            self.queue.notify_terminal(job)

    def _sweep_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.sweep_interval):
            self._expire_locked_sweep()

    # -- stats ----------------------------------------------------------
    def n_active_leases(self) -> int:
        """Currently-held lease count (the ``leases.active`` gauge)."""
        with self._lock:
            return len(self._leases)

    def n_workers(self) -> int:
        """Registered worker count (``workers.registered`` gauge)."""
        with self._lock:
            return len(self._workers)

    def cluster(self) -> dict[str, Any]:
        """The ``GET /cluster`` worker scoreboard: one row per
        registered worker — capabilities, heartbeat staleness, active
        leases with time-to-expiry, last failure, and the warm-pool
        prefetch count — plus broker-level lease totals.  This is the
        operator's "which worker is sick?" view; ``/slo`` answers
        "is the service sick?"."""
        now = _wall()
        now_m = _mono()
        with self._lock:
            workers = []
            for wid, w in sorted(self._workers.items()):
                snap = w.snapshot()
                snap["heartbeat_staleness_s"] = round(
                    max(0.0, now - w.last_seen), 3)
                snap["leases"] = [
                    {"job_id": jid,
                     "expires_in_s": round(ls.expires_at - now_m, 3)}
                    for jid, ls in sorted(self._leases.items())
                    if ls.worker_id == wid]
                workers.append(snap)
            return {"workers": workers,
                    "active_leases": len(self._leases),
                    "leases_expired": self.leases_expired,
                    "jobs_requeued": self.jobs_requeued,
                    "lease_ttl": self.lease_ttl,
                    "now": now}

    def stats(self) -> dict[str, Any]:
        """Broker counters + per-worker stats (``GET /stats`` in broker
        mode): ``jobs_done``/``jobs_failed``/``jobs_requeued``/
        ``leases_expired``, active lease count, queue-age info under
        ``queue``, and one entry per registered worker under
        ``workers``."""
        with self._lock:
            out: dict[str, Any] = {
                "mode": "broker",
                "jobs_done": self.jobs_done,
                "jobs_failed": self.jobs_failed,
                "jobs_requeued": self.jobs_requeued,
                "leases_expired": self.leases_expired,
                "active_leases": len(self._leases),
                "executables": {
                    **self.executables.stats(),
                    "uploaded": self.executables_uploaded,
                    "served": self.executables_served},
                "workers": {wid: w.snapshot()
                            for wid, w in self._workers.items()},
            }
        out["pending"] = self.queue.pending()
        out["queue"] = self.queue.queue_info()
        if self._started_at is not None:
            out["wall"] = time.time() - self._started_at
        return out
