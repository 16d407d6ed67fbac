"""PipelineWorker — a detached worker process pulling jobs from the
broker over HTTP (the cluster half of the paper's "serial on a PC, or in
parallel across a cluster").

One worker = one process on one device.  It registers its capabilities
with the broker (``POST /workers``: plugins, the card's name and count,
its transport), leases jobs (``POST /jobs/lease``), executes each job's
process list with a local :class:`~repro_torch.core.framework.PluginRunner`
on that device, heartbeats + streams per-plugin progress back (``POST
/jobs/{id}/progress``) — renewing its lease and obeying the returned
verdict — checkpoints after every step when ``--checkpoint-dir`` is set,
and hands results over either by uploading ``.npy`` bytes (``PUT
/jobs/{id}/result``) or, with ``--shared-fs``, by writing them directly
into the broker's shared results directory (atomic rename).  Wire
messages are specified in ``docs/worker-protocol.md``.

The kernel library is the worker's persistent executable: on the card
the worker's :class:`CompileCache` (its disk tier, ``--executables-dir``)
resolves it before the first launch — from disk, then from the broker's
warm pool (``GET /executables/{sig}``, prefetched at registration), and
only then by running ``nvcc``, whose library it uploads (``PUT
/executables/{sig}``) for the next cold worker.

Gang execution: a ``--max-batch N`` worker that leases several jobs
with IDENTICAL chain signatures (the broker's batch pop gangs them —
notably parameter-sweep variants, ``docs/sweeps.md``) steps them in
lockstep through ``CudaTransport.run_plugin_batch``: each plugin step is
ONE call over the whole gang, one launch of each kernel, so remote
sweeps gang exactly like local ones.  A gang step whose members share no
built step (``GangSignatureMismatch``) runs member by member, counted as
``gang.fallback``; any other error fails the gang.  Transports without
batch support (inmemory/chunked) run the members one after another.

Fault model: if this process dies (SIGKILL, OOM, node loss) it simply
stops heartbeating; the broker expires the lease and requeues the job,
and the next worker to lease it restores the last checkpoint from the
shared ``--checkpoint-dir`` onto its own device (``resumed_from``
reported via progress).  A worker that *loses* a lease (verdict
``lost``) abandons the job and discards any local state — exactly one
owner survives.

CLI (the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.service.worker \\
        --url http://127.0.0.1:8973 --checkpoint-dir /shared/ckpts \\
        --worker-id w0
    PYTHONPATH=src python -m repro_torch.service.worker --device cpu \\
        --url http://127.0.0.1:8973

The port's counterpart of ``repro.service.worker``; its ``--transport``
is ``cuda`` (the default), ``chunked`` or ``inmemory``.
"""
from __future__ import annotations

import argparse
import importlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core.framework import PluginRunner
from ..core.profiler import Profiler
from ..core.transport import (ChunkedFileTransport, CudaTransport,
                              GangSignatureMismatch, InMemoryTransport,
                              Transport, to_numpy)
from ..device import resolve_device
from ..kernels import build as kernel_build
from ..kernels.tally import tally
from ..obs.trace import Trace, use_trace
from .checkpoint import CheckpointStore
from .client import PipelineClient, ServiceError
from .compile_cache import CompileCache
from .job import chain_signature
from .wire import from_spec, registered_plugins

#: the transports a worker may run its jobs on
TRANSPORTS = ("cuda", "chunked", "inmemory")


class _Abandon(Exception):
    """Stop working on the current job (lease lost or job cancelled)."""

    def __init__(self, verdict: str):
        super().__init__(verdict)
        self.verdict = verdict


class _Heartbeat(threading.Thread):
    """Background lease renewal while a (possibly slow) plugin step or
    result upload runs: posts a progress message every ``interval``
    seconds for the active job — and a bare renewal for every other
    job leased in the same batch but not yet started, so a batch
    member's lease cannot expire while it waits its turn — and records
    the verdicts; a non-``ok`` verdict on the active job aborts the
    run loop at the next step boundary, one on a pending job drops it
    from the batch.  ``job_id=None`` (gang execution) renews only the
    ``pending`` set — gang members all post their own progress from the
    lockstep loop."""

    def __init__(self, worker: "PipelineWorker", job_id: str | None,
                 interval: float, pending: tuple[str, ...] = ()):
        super().__init__(name=f"heartbeat-{job_id or 'gang'}", daemon=True)
        self.worker = worker
        self.job_id = job_id
        self.interval = interval
        self.pending = list(pending)
        self.abort: str | None = None     # set to the fatal verdict
        self.dropped: set[str] = set()    # pending ids we lost
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            for jid in [j for j in self.pending
                        if j not in self.dropped]:
                try:                      # bare renewal, no fields
                    out = self.worker.client.progress(
                        jid, self.worker.worker_id)
                except (ServiceError, OSError):
                    continue
                if out.get("verdict") != "ok":
                    self.dropped.add(jid)
            if self.job_id is None:       # gang mode: pending-only
                continue
            # piggyback any finished-but-unshipped spans: mid-plugin
            # heartbeats are the ONLY channel that gets a slow (or
            # about-to-die) worker's history to the broker in time
            body = dict(self.worker._progress_fields)
            tr = self.worker._trace
            shipped = tr.take_unshipped() if tr is not None else []
            if shipped:
                body["spans"] = [s.to_wire() for s in shipped]
            try:
                out = self.worker.client.progress(
                    self.job_id, self.worker.worker_id, **body)
            except (ServiceError, OSError):
                if shipped:
                    tr.unship(shipped)
                continue                  # transient server hiccup
            if out.get("verdict") != "ok":
                self.abort = out.get("verdict", "lost")
                return

    def stop(self) -> None:
        self._stop.set()


class PipelineWorker:
    """Lease → run → heartbeat → hand over results, forever.

    Args:
        base_url: the broker's HTTP address.
        device: where jobs compute (default the card; raises on a host
            without one): every leased spec's loader simulates there and
            the default transports run there.
        transport_factory: job descriptor -> Transport for each leased
            job (default: a ``CudaTransport`` on ``device`` sharing
            ``compile_cache``).
        transport: the transport's name advertised at registration
            (default ``"cuda"`` with the default factory).
        checkpoint_dir: save per-plugin checkpoints here and restore on
            lease (point every worker at the SAME directory — shared
            filesystem — to get cross-worker resume of killed jobs).
        shared_fs: write results straight into the broker's
            ``results_dir`` (shared filesystem) instead of uploading
            bytes.
        plugins: advertised wire plugin names (default: everything in
            this process's registry).
        mesh_shape: advertised device shape (capacity filter; default
            the card count on the card, ``[1]`` on the CPU).
        max_batch: largest lease the worker accepts; leased jobs with
            identical chain signatures are gang-executed
            (``run_plugin_batch``) when the transport supports it.
        sweeps: advertise willingness to run parameter-sweep variants
            (False keeps this worker out of sweep fan-outs).
        poll: idle sleep between empty leases, seconds.
        heartbeat: lease-renewal cadence; default ``lease_ttl / 3``
            once registered.
        worker_id: explicit id (handy for tests/ops); default assigned
            by the broker.
        token: bearer token for a token-armed broker (sent on every
            request; mutating calls are 401 without it).
        preview_interval: minimum seconds between preview uploads while
            executing a streaming job (0 disables previews).
        compile_cache: the worker's :class:`CompileCache` — when it has
            a persistent store, registration wires it to the broker's
            warm pool: hot signatures are prefetched BEFORE the first
            lease, broker payloads are fetched on local disk misses, and
            a fresh ``nvcc`` build is uploaded (docs/worker-protocol.md).
    """

    def __init__(self, base_url: str, *,
                 device: str | torch.device = "cuda",
                 transport_factory: Callable[[dict], Transport]
                 | None = None,
                 transport: str | None = None,
                 checkpoint_dir: str | None = None,
                 shared_fs: bool = False,
                 plugins: list[str] | None = None,
                 mesh_shape: list[int] | None = None,
                 max_batch: int = 1,
                 sweeps: bool = True,
                 poll: float = 0.5,
                 heartbeat: float | None = None,
                 worker_id: str | None = None,
                 timeout: float = 60.0,
                 token: str | None = None,
                 preview_interval: float = 0.5,
                 compile_cache: CompileCache | None = None):
        self.device = resolve_device(device)
        self.client = PipelineClient(base_url, timeout=timeout,
                                     token=token)
        self.preview_interval = preview_interval
        self.compile_cache = (compile_cache if compile_cache is not None
                              else CompileCache())
        self.prefetched = 0              # warm-pool payloads landed
        if transport_factory is None:
            dev, cache = self.device, self.compile_cache
            transport_factory = lambda desc: CudaTransport(  # noqa: E731
                dev, compile_cache=cache)
            transport = transport or "cuda"
        self.transport_factory = transport_factory
        self.transport = transport
        self.checkpoints = (CheckpointStore(checkpoint_dir)
                            if checkpoint_dir else None)
        self.shared_fs = shared_fs
        self.plugins = (plugins if plugins is not None
                        else sorted(registered_plugins()))
        if mesh_shape is None:
            mesh_shape = [torch.cuda.device_count()
                          if self.device.type == "cuda" else 1]
        self.mesh_shape = mesh_shape
        self.max_batch = max_batch
        self.sweeps = sweeps
        self.poll = poll
        self.heartbeat = heartbeat
        self.worker_id = worker_id
        self.lease_ttl = 15.0
        self.results_dir: str | None = None
        self.jobs_done = 0
        self.jobs_failed = 0
        self.gang_fallbacks = 0          # gang steps run member by member
        self._registered = False
        self._progress_fields: dict[str, Any] = {}
        #: the active (solo) job's trace — heartbeats ship its finished
        #: spans to the broker (docs/observability.md)
        self._trace: Trace | None = None
        #: the registration's prefetch, recorded on the next job's trace
        self._prefetch_span: tuple[float, float, int] | None = None

    # -- registration ---------------------------------------------------
    def register(self) -> str:
        """Announce capabilities; adopt the broker's ``lease_ttl``,
        the minted per-worker secret (the client attaches it to every
        subsequent call) and ``results_dir`` when shared-fs.  With a
        persistent compile cache, also wire the warm pool and prefetch
        the broker's hottest signatures BEFORE the first lease — a cold
        worker loads the kernel library instead of running ``nvcc``.
        Returns the worker id."""
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        reply = self.client.register_worker(
            worker_id=self.worker_id, plugins=self.plugins,
            mesh_shape=self.mesh_shape, max_batch=self.max_batch,
            shared_fs=self.shared_fs, sweeps=self.sweeps, device=name,
            transport=self.transport)
        self.worker_id = reply["worker_id"]
        self.lease_ttl = float(reply.get("lease_ttl", self.lease_ttl))
        self.results_dir = reply.get("results_dir")
        if self.heartbeat is None:
            self.heartbeat = max(0.05, self.lease_ttl / 3)
        self._registered = True
        cache = self.compile_cache
        if cache.store is not None:
            cache.fetch = self.client.fetch_executable
            # uploads read self.worker_id at call time so a re-register
            # (new secret, maybe new id) stays wired
            cache.publish = lambda sig, payload: \
                self.client.upload_executable(sig, self.worker_id,
                                              payload)
            t0 = time.time()
            n = cache.prefetch(reply.get("hot_executables") or [])
            self.prefetched += n
            if n:
                self._prefetch_span = (t0, time.time(), n)
        return self.worker_id

    def _new_trace(self, desc: dict[str, Any]) -> Trace:
        """A trace under the broker's trace id for one leased job (so
        this attempt's spans land on the job's cross-process timeline);
        the first one also carries the registration's prefetch."""
        trace = Trace(desc.get("trace_id") or None,
                      worker_id=self.worker_id)
        if self._prefetch_span is not None:
            t0, t1, n = self._prefetch_span
            trace.record("executable.prefetch", t0, t1,
                         attrs={"payloads": n})
            self._prefetch_span = None
        return trace

    # -- main loop ------------------------------------------------------
    def run_forever(self) -> None:
        """Register, then lease-and-run until the process is killed."""
        while True:
            if not self.run_once():
                time.sleep(self.poll)

    def run_once(self) -> bool:
        """One lease round: identical-chain runs of the leased batch are
        gang-executed, the rest run solo.  Returns True if any job was
        run."""
        if not self._registered:
            self.register()
        try:
            # prefetched piggybacks the warm-pool count for the broker's
            # /cluster scoreboard (docs/worker-protocol.md)
            leases = self.client.lease(self.worker_id,
                                       max_jobs=self.max_batch,
                                       prefetched=self.prefetched)
        except ServiceError as e:
            if e.status in (403, 404):
                # 404: broker restarted and lost the registry.  403: our
                # secret was rotated out from under us (another process
                # re-registered this id).  Either way: re-register.
                self._registered = False
            return False
        except OSError:
            return False
        # group consecutive identical chain signatures (the broker's
        # batch pop already delivers gangs contiguously); a spec that
        # fails to parse gets a unique sentinel and fails loudly solo
        sigs: list[Any] = []
        for d in leases:
            try:
                sigs.append(chain_signature(from_spec(d["process_list"])))
            except Exception:            # noqa: BLE001
                sigs.append(("unparseable", d["job_id"]))
        dropped: set[str] = set()
        i = 0
        while i < len(leases):
            j = i + 1
            while j < len(leases) and sigs[j] == sigs[i]:
                j += 1
            group = [d for d in leases[i:j]
                     if d["job_id"] not in dropped]
            rest = tuple(d["job_id"] for d in leases[j:]
                         if d["job_id"] not in dropped)
            if len(group) > 1:
                dropped |= self._run_gang(group, pending=rest)
            elif group:
                dropped |= self._run_leased(group[0], pending=rest)
            i = j
        return bool(leases)

    # -- one job --------------------------------------------------------
    def _run_leased(self, desc: dict[str, Any],
                    pending: tuple[str, ...] = ()) -> set[str]:
        """Run one leased job; keep ``pending`` batch-mates' leases
        renewed meanwhile.  Returns the pending ids whose leases were
        lost (the caller must skip them)."""
        job_id = desc["job_id"]
        hb = _Heartbeat(self, job_id, self.heartbeat or 1.0,
                        pending=pending)
        try:
            self._execute(desc, hb)
        except _Abandon:
            pass          # broker said lost/cancelled: walk away quietly
        except Exception as e:           # noqa: BLE001 — report upstream
            self._fail_remote(job_id, e, trace=self._trace)
        finally:
            hb.stop()
            self._trace = None
        return hb.dropped

    def _check(self, job_id: str, transient: dict[str, Any] | None = None,
               **fields: Any) -> None:
        """Post a progress heartbeat and enforce the verdict.

        ``transient`` fields ride on THIS post only — they never enter
        ``_progress_fields``, which the heartbeat thread re-posts
        verbatim (a one-shot measurement like ``window_latency`` must
        not be re-observed on every renewal)."""
        # rebind instead of .update(): the heartbeat thread snapshots
        # this dict concurrently, and a dict is never mutated once
        # published (no resize-during-copy race)
        self._progress_fields = {**self._progress_fields, **fields}
        # spans ride along transiently — NOT in _progress_fields, which
        # the heartbeat thread re-posts verbatim (the broker dedups on
        # span_id anyway, this just keeps payloads lean)
        body = {**self._progress_fields, **(transient or {})}
        tr = self._trace
        shipped = tr.take_unshipped() if tr is not None else []
        if shipped:
            body["spans"] = [s.to_wire() for s in shipped]
        try:
            out = self.client.progress(job_id, self.worker_id, **body)
        except (ServiceError, OSError):
            if shipped:
                tr.unship(shipped)       # retry on the next heartbeat
            raise
        verdict = out.get("verdict")
        if verdict != "ok":
            raise _Abandon(verdict or "lost")

    def _runner(self, desc: dict[str, Any], transport: Transport,
                trace: Trace) -> PluginRunner:
        """A prepared runner for one leased job on ``transport``'s
        device (its loader simulates there), upstream results fetched."""
        pl = from_spec(desc["process_list"], device=transport.device)
        self._resolve_upstream(pl, trace)
        runner = PluginRunner(pl, transport, profiler=Profiler(
            trace=trace, worker_id=self.worker_id))
        runner.prepare()
        return runner

    def _execute(self, desc: dict[str, Any], hb: _Heartbeat) -> None:
        job_id = desc["job_id"]
        self._progress_fields = {}
        trace = self._new_trace(desc)
        self._trace = trace
        # cheap lease confirm BEFORE any expensive prepare/restore — a
        # batch-mate whose lease expired while it waited abandons here
        self._check(job_id)
        # renewals (this job bare, batch-mates pending) start NOW, not
        # after prepare: a slow first prepare must not eat the TTL of
        # every lease in the batch
        hb.start()
        with use_trace(trace), \
                trace.span("attempt", attempt=desc.get("attempt")):
            runner = self._runner(desc, self.transport_factory(desc),
                                  trace)
            resumed = 0
            if self.checkpoints is not None:
                with trace.span("checkpoint.restore"):
                    resumed = self.checkpoints.restore(job_id, runner)
            self._check(job_id, plugin_index=runner.current_step,
                        n_plugins=runner.n_steps, resumed_from=resumed,
                        **({"checkpoint": self.checkpoints.root}
                           if self.checkpoints else {}))
            if getattr(runner.process_list, "streaming", False):
                self._stream_steps(job_id, runner, hb, trace)
            else:
                while True:
                    if hb.abort:
                        raise _Abandon(hb.abort)
                    if not runner.step():
                        break
                    if self.checkpoints is not None:
                        with trace.span("checkpoint.save"):
                            self.checkpoints.save(job_id, runner)
                    self._check(job_id, plugin_index=runner.current_step)
            runner.finalise()
            # the heartbeat keeps renewing through hand-over + complete:
            # a result upload slower than lease_ttl must not lose the
            # lease (hb is stopped by _run_leased's finally)
            with trace.span("result.upload"):
                results = self._hand_over(job_id, runner)
        self._complete(job_id, runner, results, trace)

    def _complete(self, job_id: str, runner: PluginRunner,
                  results: dict[str, Any], trace: Trace) -> None:
        self.client.complete(job_id, self.worker_id, "done",
                             results=results,
                             plugin_index=runner.current_step,
                             n_plugins=runner.n_steps,
                             spans=[s.to_wire()
                                    for s in trace.take_unshipped()])
        self.jobs_done += 1
        if self.checkpoints is not None:
            self.checkpoints.clear(job_id)

    def _resolve_upstream(self, pl: Any, trace: Trace) -> None:
        """Fetch upstream workflow outputs referenced by split-form
        ``from_job``/``dataset`` params (the broker normalises
        descriptor references to this form for upload-mode workers;
        shared-fs descriptors carry a ``path`` instead, which
        ``upstream_loader`` reads directly) — docs/workflows.md."""
        for e in pl.entries:
            params = e.params
            fj = params.get("from_job")
            if not isinstance(fj, str) or params.get("data") is not None \
                    or params.get("path"):
                continue
            with trace.span("upstream.fetch", from_job=fj):
                params["data"] = self.client.result(
                    fj, params.get("dataset") or None)

    # -- streaming --------------------------------------------------------
    def _stream_steps(self, job_id: str, runner: PluginRunner,
                      hb: _Heartbeat, trace: Trace) -> None:
        """Arrival-driven execution of a streaming job
        (docs/streaming.md): fetch newly-ingested frames from the
        broker, feed them to the runner, pump whatever became runnable,
        and ship rate-limited previews.  A starved stream does not hold
        a lease hostage: with checkpoints enabled the worker saves and
        asks to be PARKED — the broker ends the lease without burning
        an attempt and requeues the job, freeing this worker until
        more frames land."""
        runner.enable_streaming()        # idempotent after restore
        state = runner.stream_state()
        total = state["total"]
        fed = state["ingested"]
        eof_marked = state["eof"]
        last_preview = 0.0
        while runner.current_step < runner.n_steps:
            if hb.abort:
                raise _Abandon(hb.abort)
            try:
                frames, start, eof, _ = self.client.fetch_frames(
                    job_id, start=fed)
            except (ServiceError, OSError):
                time.sleep(min(self.poll, 0.25))
                continue                 # transient broker hiccup
            if frames is None and not eof:
                # starved.  Checkpoint + park so the broker can hand the
                # lease to nobody (the queue holds the job until frames
                # arrive); without checkpoints parking would restart the
                # job from scratch on re-lease, so hold on and wait.
                if self.checkpoints is not None:
                    with trace.span("checkpoint.save"):
                        self.checkpoints.save(job_id, runner)
                    try:
                        out = self.client.progress(
                            job_id, self.worker_id,
                            ingest_watermark=fed, park=True)
                    except (ServiceError, OSError):
                        time.sleep(min(self.poll, 0.25))
                        continue
                    if out.get("verdict") != "ok":
                        raise _Abandon(out.get("verdict", "parked"))
                time.sleep(min(self.poll, 0.25))
                continue
            if frames is None and eof and fed < total:
                raise RuntimeError(
                    f"stream ended at frame {fed} but the loader "
                    f"declares {total} frames")
            if frames is not None:
                fed = runner.feed(frames, int(start))
            if eof and fed == total and not eof_marked:
                runner.mark_eof()
                eof_marked = True
            t0 = time.time()
            did = runner.pump()
            pumped = time.time() - t0
            if frames is None and not did and \
                    runner.current_step < runner.n_steps:
                raise RuntimeError("streaming job stalled after EOF: "
                                   "no step is runnable")
            if self.checkpoints is not None:
                with trace.span("checkpoint.save"):
                    self.checkpoints.save(job_id, runner)
            # window latency is a one-shot observation → transient, so
            # lease renewals can't re-observe it (docs/streaming.md)
            self._check(job_id, plugin_index=runner.current_step,
                        ingest_watermark=fed,
                        transient={"window_latency": pumped}
                        if did else None)
            if self.preview_interval > 0 and \
                    time.time() - last_preview >= self.preview_interval:
                last_preview = time.time()
                self._ship_preview(job_id, runner)

    def _ship_preview(self, job_id: str, runner: PluginRunner) -> None:
        """Best-effort upload of the partial reconstruction as the
        ``__preview__`` result, then report its watermark.  Failures are
        swallowed — previews are advisory, the stream must not die for
        one."""
        try:
            arr, cut = runner.preview()
        except ValueError:
            return                       # nothing reconstructed yet
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(to_numpy(arr)))
        try:
            self.client.upload_result(job_id, self.worker_id,
                                      "__preview__", buf.getvalue())
            self._check(job_id, preview_watermark=int(cut))
        except (ServiceError, OSError):
            pass

    # -- gang execution ---------------------------------------------------
    def _verdict(self, job_id: str, trace: Trace | None = None,
                 **fields: Any) -> str:
        """One per-job progress post (shipping ``trace``'s unshipped
        spans when given); returns the broker's verdict."""
        shipped = trace.take_unshipped() if trace is not None else []
        if shipped:
            fields = {**fields,
                      "spans": [s.to_wire() for s in shipped]}
        try:
            out = self.client.progress(job_id, self.worker_id, **fields)
        except (ServiceError, OSError):
            if shipped:
                trace.unship(shipped)    # retry on the next post
            raise
        return out.get("verdict", "lost")

    def _fail_remote(self, job_id: str, exc: Exception,
                     trace: Trace | None = None) -> None:
        self.jobs_failed += 1
        try:
            self.client.complete(
                job_id, self.worker_id, "failed",
                error=f"{type(exc).__name__}: {exc}",
                spans=[s.to_wire() for s in trace.take_unshipped()]
                if trace is not None else [])
        except (ServiceError, OSError):
            pass                         # lease lost: nothing to report

    def _gang_step(self, transport: Transport,
                   live: list[tuple[dict[str, Any], PluginRunner]],
                   traces: dict[str, Trace]) -> None:
        """One lockstep step of the gang: ONE ``run_plugin_batch`` call
        (one launch of each kernel) when every member runs one plugin
        and the transport gangs, else member by member.  Every member's
        ``process`` span gets the shared wall, the gang size, the step's
        cost (with cost analysis) and the launches it made."""
        groups = [r.begin_step() for _, r in live]
        batched = (len(live) > 1 and len(groups[0]) == 1
                   and hasattr(transport, "run_plugin_batch"))
        cost = (transport.plugin_cost(*[g[0] for g in groups])
                if batched and hasattr(transport, "plugin_cost") else None)
        t0 = time.time()
        # the first member's trace records what the step builds or
        # loads (the kernel library at a worker's first launch)
        with use_trace(traces[live[0][0]["job_id"]]), tally() as launched:
            if batched:
                try:
                    transport.run_plugin_batch([g[0] for g in groups])
                except GangSignatureMismatch as e:
                    self._gang_fallback(live, traces, groups[0][0].name,
                                        e)
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
        for (_, r), g in zip(live, groups):
            r.profiler.record(g[0].name, "process", t0, t1,
                              gang=len(live), **(cost or {}),
                              **launched.launch_attrs())
            r.complete_step()

    def _gang_fallback(self, live, traces: dict[str, Trace], plugin: str,
                       err: Exception) -> None:
        """A gang step whose members share no built step runs member by
        member: count it and mark each member's trace."""
        self.gang_fallbacks += 1
        now = time.time()
        for d, _ in live:
            traces[d["job_id"]].record(
                "gang.fallback", now, now,
                attrs={"plugin": plugin, "gang": len(live),
                       "reason": str(err)})

    def _run_gang(self, descs: list[dict[str, Any]],
                  pending: tuple[str, ...] = ()) -> set[str]:
        """Execute leased jobs with identical chain signatures in
        lockstep: ONE transport, each single-plugin step as one
        ``run_plugin_batch`` call over the whole gang (:meth:`_gang_step`)
        — so remote parameter sweeps gang exactly like local ones.
        Transports without batch support run the members one after
        another; a member restored from a checkpoint is handed back to
        the solo path (a gang would drag it to step 0).  Returns the ids
        whose leases were lost (caller must skip them)."""
        ids = [d["job_id"] for d in descs]
        transport = self.transport_factory(descs[0])
        if not hasattr(transport, "run_plugin_batch"):
            dropped: set[str] = set()
            for i, d in enumerate(descs):
                if d["job_id"] in dropped:
                    continue
                rest = tuple(x for x in ids[i + 1:]
                             if x not in dropped) + tuple(pending)
                dropped |= self._run_leased(d, pending=rest)
            return dropped
        hb = _Heartbeat(self, None, self.heartbeat or 1.0,
                        pending=tuple(ids) + tuple(pending))
        dropped = set()
        live: list[tuple[dict[str, Any], PluginRunner]] = []
        # per-job traces: gang members interleave on this thread, and
        # the per-(trace, thread) parent stacks keep each job's span
        # links straight
        traces: dict[str, Trace] = {d["job_id"]: self._new_trace(d)
                                    for d in descs}
        try:
            hb.start()
            solo: list[dict[str, Any]] = []
            for d in descs:
                jid = d["job_id"]
                if self.checkpoints is not None and \
                        self.checkpoints.load(jid) is not None:
                    # a checkpoint exists: resume solo (a gang would
                    # drag it back to step 0); manifest-only probe — the
                    # solo path does the actual restore
                    solo.append(d)
                    continue
                tr = traces[jid]
                try:
                    if self._verdict(jid) != "ok":
                        dropped.add(jid)
                        continue
                    with use_trace(tr):
                        runner = self._runner(d, transport, tr)
                    if self._verdict(jid, trace=tr, plugin_index=0,
                                     n_plugins=runner.n_steps,
                                     **({"checkpoint": self.checkpoints.root}
                                        if self.checkpoints else {})) != "ok":
                        dropped.add(jid)
                        continue
                except (ServiceError, OSError):
                    dropped.add(jid)
                    continue
                except Exception as e:   # noqa: BLE001 — report upstream
                    self._fail_remote(jid, e, trace=tr)
                    continue
                live.append((d, runner))
            # lockstep: one batched call per plugin step
            exc: Exception | None = None
            step_total = live[0][1].n_steps if live else 0
            for _ in range(step_total):
                if not live:
                    break
                try:
                    self._gang_step(transport, live, traces)
                except Exception as e:   # noqa: BLE001 — fails the gang
                    exc = e
                    break
                keep = []
                for d, r in live:
                    jid = d["job_id"]
                    if jid in hb.dropped:
                        dropped.add(jid)
                        continue
                    if self.checkpoints is not None:
                        with traces[jid].span("checkpoint.save"):
                            self.checkpoints.save(jid, r)
                    try:
                        v = self._verdict(jid, trace=traces[jid],
                                          plugin_index=r.current_step)
                    except (ServiceError, OSError):
                        v = "ok"        # transient; hb catches real loss
                    if v != "ok":
                        dropped.add(jid)
                        continue
                    keep.append((d, r))
                live = keep
            if exc is not None:
                for d, _ in live:
                    self._fail_remote(d["job_id"], exc,
                                      trace=traces[d["job_id"]])
                live = []
            for d, r in live:
                jid = d["job_id"]
                tr = traces[jid]
                try:
                    r.finalise()
                    with tr.span("result.upload"):
                        results = self._hand_over(jid, r)
                    self._complete(jid, r, results, tr)
                except (ServiceError, OSError):
                    dropped.add(jid)     # lease lost at hand-over
                except Exception as e:   # noqa: BLE001
                    self._fail_remote(jid, e, trace=tr)
            # checkpointed members go back through the solo path (fresh
            # transport + restore; leases were renewed by hb meanwhile)
            for i, d in enumerate(solo):
                if d["job_id"] in dropped | hb.dropped:
                    continue
                rest = tuple(x["job_id"] for x in solo[i + 1:]) \
                    + tuple(pending)
                dropped |= self._run_leased(d, pending=rest)
        finally:
            hb.stop()
        return dropped | hb.dropped

    def _hand_over(self, job_id: str,
                   runner: PluginRunner) -> dict[str, Any]:
        """Deliver every saver output (copied to the host by the
        transport's ``read``): write an ``.npy`` into the broker's
        shared results_dir, or upload the bytes."""
        results: dict[str, Any] = {}
        for name in runner.result_names():
            arr = np.ascontiguousarray(
                runner.transport.read(runner.datasets[name]))
            if self.shared_fs and self.results_dir:
                results[name] = {
                    "path": self._link_result(job_id, name, arr)}
            else:
                buf = io.BytesIO()
                np.save(buf, arr)
                self.client.upload_result(job_id, self.worker_id, name,
                                          buf.getvalue())
                results[name] = {"uploaded": True}
        return results

    def _link_result(self, job_id: str, name: str,
                     arr: np.ndarray) -> str:
        """Write the ``.npy`` straight into the broker's shared
        results_dir (per-worker tmp name + atomic rename, so two
        owners racing a requeue can never interleave bytes)."""
        d = os.path.join(self.results_dir, job_id.replace(os.sep, "_"))
        os.makedirs(d, exist_ok=True)
        dst = os.path.join(d, f"{name}.npy")
        tmp = f"{dst}.{self.worker_id}.tmp"
        with open(tmp, "wb") as fh:
            np.save(fh, arr)
        os.replace(tmp, dst)
        return dst


# ----------------------------------------------------------------------
def spawn_local_workers(url: str, n: int, *, transport: str = "cuda",
                        device: str = "cuda",
                        checkpoint_dir: str | None = None,
                        shared_fs: bool = False, poll: float = 0.1,
                        heartbeat: float | None = None,
                        max_batch: int = 1,
                        imports: tuple[str, ...] = (),
                        worker_ids: list[str] | None = None,
                        pythonpath_extra: tuple[str, ...] = (),
                        token: str | None = None,
                        executables_dir: str | None = None,
                        cost_analysis: bool = False,
                        stdout: Any = None) -> list[subprocess.Popen]:
    """Spawn ``n`` worker subprocesses against a broker URL — the
    ``pipeline_serve --workers-remote N`` demo, ``chip_smoke.py`` and
    the tests all use this.  Each worker is a fresh interpreter (nothing
    CUDA crosses a ``fork``) with its own CUDA context on ``device``
    (the card unless ``"cpu"``); kill one to exercise the lease-expiry/
    resume path.  Returns the ``Popen`` handles; the caller stops
    them."""
    resolve_device(device)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    parts = [src, *pythonpath_extra]
    if env.get("PYTHONPATH"):
        parts.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(parts)
    procs = []
    for i in range(n):
        # -c instead of -m: repro_torch.service.__init__ imports this
        # module, so runpy would warn about the double import
        cmd = [sys.executable, "-c",
               "from repro_torch.service.worker import main; main()",
               "--url", url, "--transport", transport, "--device", device,
               "--poll", str(poll),
               "--worker-id",
               (worker_ids[i] if worker_ids else f"local-{i}")]
        if checkpoint_dir:
            cmd += ["--checkpoint-dir", checkpoint_dir]
        if shared_fs:
            cmd += ["--shared-fs"]
        if heartbeat is not None:
            cmd += ["--heartbeat", str(heartbeat)]
        if max_batch != 1:
            cmd += ["--max-batch", str(max_batch)]
        for mod in imports:
            cmd += ["--import", mod]
        if token is not None:
            cmd += ["--token", token]
        if executables_dir is not None:
            cmd += ["--executables-dir", executables_dir]
        if cost_analysis:
            cmd += ["--cost-analysis"]
        procs.append(subprocess.Popen(cmd, env=env, stdout=stdout,
                                      stderr=stdout))
    return procs


def _transport_factory(kind: str, scratch: str,
                       device: str | torch.device = "cuda",
                       compile_cache: CompileCache | None = None,
                       cost_analysis: bool = False
                       ) -> Callable[[dict], Transport]:
    """Job descriptor -> a fresh transport of ``kind`` on ``device``;
    ``cuda`` transports share ``compile_cache`` (process-level)."""
    dev = resolve_device(device)
    if kind == "cuda":
        cache = (compile_cache if compile_cache is not None
                 else CompileCache())
        return lambda desc: CudaTransport(dev, compile_cache=cache,
                                          cost_analysis=cost_analysis)
    if cost_analysis:
        raise ValueError("cost analysis needs the cuda transport")
    if kind == "chunked":
        return lambda desc: ChunkedFileTransport(
            os.path.join(scratch, desc["job_id"]), device=dev)
    if kind == "inmemory":
        return lambda desc: InMemoryTransport(dev)
    raise ValueError(f"unknown transport {kind!r} (one of {TRANSPORTS})")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.service.worker",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--url", default="http://127.0.0.1:8973",
                    help="broker base URL")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or "
                         "'cpu'")
    ap.add_argument("--transport", default="cuda", choices=TRANSPORTS)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="shared checkpoint directory (cross-worker "
                         "resume needs every worker pointed here)")
    ap.add_argument("--shared-fs", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="write results straight into the broker's "
                         "results_dir (shared filesystem) instead of "
                         "uploading")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="largest lease accepted; identical-chain "
                         "batches (e.g. sweep variants) gang-execute")
    ap.add_argument("--sweeps", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="accept parameter-sweep variant jobs "
                         "(--no-sweeps keeps this worker out of sweep "
                         "fan-outs)")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="idle sleep between empty leases, seconds")
    ap.add_argument("--heartbeat", type=float, default=None,
                    help="lease-renewal cadence (default lease_ttl/3)")
    ap.add_argument("--import", dest="imports", action="append",
                    default=[], metavar="MODULE",
                    help="import MODULE before serving (register extra "
                         "wire plugins; repeatable)")
    ap.add_argument("--token", default=None,
                    help="bearer token for a token-armed broker "
                         "(mutating requests are 401 without it)")
    ap.add_argument("--preview-interval", type=float, default=0.5,
                    help="minimum seconds between preview uploads on "
                         "streaming jobs (0 disables previews)")
    ap.add_argument("--executables-dir", default=None,
                    help="disk tier of the kernel library (default on "
                         "the card: the checkout's build/kernels/, which "
                         "workers of one host share)")
    ap.add_argument("--cost-analysis",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="--transport cuda: attach per-step flops, bytes "
                         "accessed and peak memory to the process spans")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for mod in args.imports:
        importlib.import_module(mod)
    scratch = tempfile.mkdtemp(prefix="pipeline-worker-")
    exe_dir = args.executables_dir or (
        str(kernel_build.BUILD_DIR) if dev.type == "cuda" else None)
    compile_cache = CompileCache(store=exe_dir)
    if exe_dir is not None:
        # the library is resolved once, at the first launch, through
        # the disk tier, the broker's warm pool, then nvcc
        kernel_build.use_resolver(compile_cache.kernel_library)
    worker = PipelineWorker(
        args.url, device=dev,
        transport_factory=_transport_factory(
            args.transport, scratch, dev, compile_cache=compile_cache,
            cost_analysis=args.cost_analysis),
        transport=args.transport,
        checkpoint_dir=args.checkpoint_dir, shared_fs=args.shared_fs,
        worker_id=args.worker_id, max_batch=args.max_batch,
        sweeps=args.sweeps, poll=args.poll, heartbeat=args.heartbeat,
        token=args.token, preview_interval=args.preview_interval,
        compile_cache=compile_cache)
    wid = worker.register()
    print(f"worker {wid} serving {args.url} "
          f"(device={dev}, transport={args.transport}, "
          f"plugins={len(worker.plugins)}"
          f"{', checkpointed' if worker.checkpoints else ''}"
          f"{', shared-fs' if args.shared_fs else ''}"
          f"{f', prefetched={worker.prefetched}' if worker.prefetched else ''}"
          f")", flush=True)
    try:
        worker.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main()
