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

The port's copy of ``repro.service.scheduler.PipelineScheduler``; the
broker of multi-host mode (``WorkerBroker``, leases, executables) comes
with the worker slice (ROADMAP.md "Next" D1).  Without a
``transport_factory`` every job runs on an ``InMemoryTransport`` on the
card; a caller on the CPU passes a factory of CPU transports.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from ..core.framework import PluginRunner
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
    def _streaming_job(self, job_id: str) -> Job:
        job = self.queue.job(job_id)
        if not job.streaming:
            raise RuntimeError(f"job {job_id!r} is not a streaming job "
                               f'(submit with spec v2 "streaming": true)')
        return job

    def ingest_frames(self, job_id: str, frames: np.ndarray,
                      start: int) -> dict[str, Any]:
        """Accept one contiguous frame chunk for a streaming job — the
        in-process counterpart of the front end's ``POST
        /jobs/{id}/frames``.  ``start`` must equal the job's ingest
        watermark (a resubmitted job's starts at its checkpoint's
        ``stream.ingested``: the producer re-sends from there);
        out-of-order, duplicate and
        after-EOF chunks raise RuntimeError.  Wakes the queue (a parked
        streaming job becomes runnable) and the job's driver."""
        job = self._streaming_job(job_id)
        if job.state.terminal():
            raise RuntimeError(f"job {job_id!r} is {job.state.value}; "
                               f"ingest is closed")
        frames = np.ascontiguousarray(frames)
        if frames.ndim < 1 or frames.shape[0] == 0:
            raise RuntimeError("frames chunk must have >= 1 frame on "
                               "axis 0")
        st = job.stream
        with st.lock:
            if st.eof:
                raise RuntimeError(f"job {job_id!r} already got EOF; no "
                                   f"more frames accepted")
            if st.watermark == 0:
                st.rebase(self._resume_watermark(job_id))
            if start != st.watermark:
                raise RuntimeError(
                    f"out-of-order ingest for job {job_id!r}: chunk "
                    f"starts at frame {start} but the watermark is "
                    f"{st.watermark} (duplicate or gap)")
            watermark = st.append(frames, start)
            st.cond.notify_all()
        self.queue.kick()
        if self.metrics is not None:
            self.metrics.counter("stream.frames.ingested").inc(
                int(frames.shape[0]))
        return {"job_id": job_id, "start": int(start),
                "count": int(frames.shape[0]), "watermark": watermark}

    def _resume_watermark(self, job_id: str) -> int:
        """Frames a checkpoint of ``job_id`` already ingested (0 without
        one): where a resubmitted streaming job's frames restart."""
        man = (self.checkpoints.load(job_id)
               if self.checkpoints is not None else None)
        return int(((man or {}).get("stream") or {}).get("ingested", 0))

    def mark_eof(self, job_id: str) -> dict[str, Any]:
        """End of acquisition (the front end's ``POST /jobs/{id}/eof``):
        no more frames will arrive.  A second EOF on a live stream
        raises; EOF on a stream that already ran to completion
        succeeds."""
        job = self._streaming_job(job_id)
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
        self.queue.kick()
        return {"job_id": job_id, "eof": True, "watermark": watermark}

    def preview(self, job_id: str) -> tuple[np.ndarray, int]:
        """Partial reconstruction over the frames consumed so far (the
        front end's ``GET /jobs/{id}/preview``): ``(array,
        frames_covered)``, computed from the live runner under
        ``stream.exec_lock``.  Raises RuntimeError/ValueError while no
        preview can be produced yet."""
        job = self._streaming_job(job_id)
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
