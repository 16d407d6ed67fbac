"""JobQueue — priority admission queue for pipeline jobs.

Higher ``priority`` pops first; equal priorities are FIFO.  Admission
control bounds the number of non-terminal jobs in the system
(``max_pending``): past the bound, ``submit`` either raises
:class:`QueueFull` (caller sheds load) or, with ``block=True``, applies
backpressure by waiting for capacity.  ``get_batch`` pops the head job
plus queued jobs with the SAME chain signature so the scheduler can gang
them into one compiled call per plugin step.

Jobs may depend on jobs (``after=[job_id]``, fan-out/fan-in — the
workflow-DAG substrate, docs/workflows.md): a job with dependencies is
not poppable until every upstream reached DONE.  An upstream that
fails or is cancelled cascade-cancels its whole downstream cone with a
machine-readable ``cancel_reason``; evicting a DONE upstream whose
RESULTS a queued downstream still needs (``data_deps``) cancels that
downstream with ``upstream_evicted``.  The queue performs those
transitions itself, so it exposes ``add_terminal_hook`` — the service
attaches metrics attribution there and every terminal transition is
observed exactly once, whether the scheduler, the broker or the queue
made it.

The port's copy of ``repro.service.queue`` (it holds no tensors); the
lease and requeue paths serve the broker of the worker slice.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable

from ..core.process_list import ProcessList
from .job import Job, JobState


class QueueFull(RuntimeError):
    """Admission control rejected the submission (queue at max_pending)."""


class JobQueue:
    """Priority admission queue — the service side of the paper's
    "simultaneous processing of multiple datasets" (§I): many users'
    process lists queued against one facility pipeline.  Thread-safe;
    shared between HTTP handler threads and scheduler workers."""

    def __init__(self, max_pending: int | None = None,
                 max_history: int | None = None):
        """Args:
            max_pending: bound on non-terminal jobs; ``submit`` past it
                raises :class:`QueueFull` (or blocks with ``block=True``).
                None = unbounded.
            max_history: bound on retained TERMINAL jobs: beyond it the
                oldest finished jobs are evicted (their runner —
                datasets, device buffers, transport — released with
                them).  None keeps everything, which is right for batch
                CLIs/tests that read results after drain but leaks in a
                long-lived service.
        """
        self.max_pending = max_pending
        self.max_history = max_history
        self._heap: list[tuple[int, int, Job]] = []
        self._jobs: dict[str, Job] = {}
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._capacity = threading.Condition(self._lock)
        self._seq = itertools.count()
        self._evict_hooks: list[Callable[[Job], None]] = []
        self._terminal_hooks: list[Callable[[Job], None]] = []
        #: upstream job id -> ids of jobs submitted with it in ``after``
        self._downstream: dict[str, set[str]] = {}
        #: structured event log (set by the service); the queue emits
        #: ``job.submit`` for every admitted job — the one transition
        #: only the queue sees, whatever path (submit / sweeps /
        #: workflows) admitted it (docs/observability.md)
        self.events = None

    def _emit_submitted(self, jobs: list[Job]) -> None:
        if self.events is None:
            return
        for job in jobs:
            self.events.emit("job.submit", trace_id=job.trace_id,
                             job_id=job.job_id, priority=job.priority,
                             **({"after": list(job.after)}
                                if job.after else {}))

    def add_terminal_hook(self, hook: Callable[[Job], None]) -> None:
        """Register a callback fired for each terminal transition the
        QUEUE ITSELF performs — queue-side cancels and dependency
        cascades (``upstream_failed``/``upstream_cancelled``/
        ``upstream_evicted``).  The scheduler and broker observe their
        own transitions; this hook closes the gap so e.g. the
        ``jobs.cancelled`` metric counts every cancellation exactly
        once.  Called outside the queue lock; exceptions are
        swallowed."""
        self._terminal_hooks.append(hook)

    def _fire_terminal_hooks(self, jobs: list[Job]) -> None:
        for job in jobs:
            for hook in self._terminal_hooks:
                try:
                    hook(job)
                except Exception:  # noqa: BLE001 — telemetry best-effort
                    pass

    def add_evict_hook(self, hook: Callable[[Job], None]) -> None:
        """Register a callback fired for each TERMINAL job evicted by
        ``max_history`` pruning — how the broker ties its result spool
        GC to job retention.  Called with the evicted Job *after* it is
        removed and *outside* the queue lock (hooks may do filesystem
        I/O); exceptions are swallowed."""
        self._evict_hooks.append(hook)

    def _fire_evict_hooks(self, evicted: list[Job]) -> None:
        for job in evicted:
            for hook in self._evict_hooks:
                try:
                    hook(job)
                except Exception:    # noqa: BLE001 — GC best-effort
                    pass

    # -- dependencies (workflow DAGs, docs/workflows.md) ----------------
    @staticmethod
    def _check_after(job_id: str, after, data_deps, known) -> tuple:
        """Validate + normalise one job's dependency declaration.
        ``data_deps`` are dependencies too (merged into ``after``);
        every upstream id must be in ``known`` and self-references are
        refused.  Returns ``(after, data_deps)`` as deduped tuples."""
        dd = tuple(dict.fromkeys(data_deps or ()))
        merged = tuple(dict.fromkeys(tuple(after or ()) + dd))
        for uid in merged:
            if uid == job_id:
                raise ValueError(
                    f"job {job_id!r} cannot depend on itself")
            if uid not in known:
                raise ValueError(
                    f"unknown upstream job {uid!r} in after=[...] "
                    f"(submitted earlier and evicted, or never "
                    f"submitted)")
        return merged, dd

    def _cancel_dep_locked(self, job: Job, reason: str,
                           err: str) -> list[Job]:
        """Cancel a QUEUED job for a dependency reason, then cascade
        through its own downstream cone.  Returns every job cancelled
        (for the terminal hooks, fired outside the lock)."""
        if job.state is not JobState.QUEUED:
            return []
        job.state = JobState.CANCELLED
        job.cancel_reason = reason
        job.error = err
        job.finished_at = time.time()
        return [job] + self._propagate_terminal_locked(job)

    def _propagate_terminal_locked(self, job: Job) -> list[Job]:
        """``job`` reached a terminal state: clear it from downstream
        ``waiting`` sets (DONE — fan-in edges resolve, newly ready jobs
        wake waiters) or cascade-cancel the downstream cone (FAILED/
        CANCELLED).  Returns the jobs the queue cancelled."""
        cancelled: list[Job] = []
        woke = False
        for did in sorted(self._downstream.get(job.job_id, ())):
            d = self._jobs.get(did)
            if d is None or d.state is not JobState.QUEUED:
                continue
            if job.state is JobState.DONE:
                d.waiting.discard(job.job_id)
                woke = woke or d.deps_ready()
            elif job.job_id in d.waiting:
                reason = ("upstream_cancelled"
                          if job.state is JobState.CANCELLED
                          else "upstream_failed")
                cancelled.extend(self._cancel_dep_locked(
                    d, reason,
                    f"upstream {job.job_id} {job.state.value}"))
        if woke or cancelled:
            self._not_empty.notify_all()
            self._capacity.notify_all()
        return cancelled

    def _wire_deps_locked(self, job: Job, after: tuple[str, ...],
                          data_deps: tuple[str, ...]) -> list[Job]:
        """Record ``job``'s upstream edges (ids pre-validated).  DONE
        upstreams are satisfied immediately; an upstream that already
        failed/was cancelled applies the cascade rule at admission —
        the job is admitted, then cancelled like any other downstream.
        Returns the jobs cancelled that way."""
        job.after = after
        job.data_deps = data_deps
        job.waiting = set()
        for uid in after:
            self._downstream.setdefault(uid, set()).add(job.job_id)
            up = self._jobs.get(uid)
            if up is None or not up.state.terminal():
                job.waiting.add(uid)
        for uid in after:
            up = self._jobs.get(uid)
            if up is not None and up.state.terminal() \
                    and up.state is not JobState.DONE:
                reason = ("upstream_cancelled"
                          if up.state is JobState.CANCELLED
                          else "upstream_failed")
                return self._cancel_dep_locked(
                    job, reason, f"upstream {uid} {up.state.value}")
        return []

    # -- admission ------------------------------------------------------
    def _pending_locked(self) -> int:
        return sum(1 for j in self._jobs.values() if not j.state.terminal())

    def _prune_locked(self) -> tuple[list[Job], list[Job]]:
        """Evict over-history terminal jobs; returns ``(evicted,
        dep_cancelled)`` so the caller can fire the evict + terminal
        hooks once the lock is released.  Evicting a DONE upstream
        whose results a queued downstream still needs (``data_deps``)
        cancels that downstream with ``upstream_evicted``."""
        if self.max_history is None:
            return [], []
        terminal = sorted((j for j in self._jobs.values()
                           if j.state.terminal()), key=lambda j: j.seq)
        evicted = terminal[:max(0, len(terminal) - self.max_history)]
        for j in evicted:
            j.runner = None
            del self._jobs[j.job_id]
        cancelled: list[Job] = []
        for j in evicted:
            for did in sorted(self._downstream.pop(j.job_id, ())):
                d = self._jobs.get(did)
                if d is None or d.state is not JobState.QUEUED:
                    continue
                if j.job_id in d.data_deps:
                    cancelled.extend(self._cancel_dep_locked(
                        d, "upstream_evicted",
                        f"upstream {j.job_id} result evicted from "
                        f"history"))
                else:
                    d.waiting.discard(j.job_id)
        return evicted, cancelled

    def submit(self, process_list: ProcessList, *, priority: int = 0,
               job_id: str | None = None, block: bool = False,
               timeout: float | None = None,
               metadata: dict[str, Any] | None = None,
               trace_id: str | None = None,
               after: list[str] | None = None,
               data_deps: list[str] | None = None) -> Job:
        """Admit one process list as a :class:`Job`.

        Args:
            process_list: the chain to run (checked at dispatch, not
                here — use ``ProcessList.check()`` first to fail fast).
            priority: higher pops first; FIFO within a priority.
            job_id: explicit id (resubmit a killed job's id to resume
                from its checkpoint); default ``job-{seq:04d}``.
            block: past ``max_pending``, wait for capacity instead of
                raising.
            timeout: cap on the ``block=True`` wait, in seconds.
            metadata: free-form annotations carried on the job.
            trace_id: explicit telemetry trace id (correlate with an
                external tracer); default a fresh one per job.
            after: upstream job ids this job must wait for; the job is
                only poppable once every one reached DONE, and an
                upstream failure/cancel cascades (docs/workflows.md).
            data_deps: the subset of upstreams whose RESULTS this job
                consumes (auto-added to ``after``); evicting one
                before this job runs cancels it (upstream_evicted).

        Returns: the QUEUED job (possibly already CANCELLED, if an
            upstream in ``after`` had already failed).
        Raises:
            QueueFull: admission rejected (or the blocking wait timed
                out).
            ValueError: ``job_id`` names a still-active job, or
                ``after`` names an unknown upstream / the job itself.
        """
        def check_id():
            # re-checked after every capacity wait: two blocked
            # submitters with the same explicit id must not both insert
            if (job_id in self._jobs
                    and not self._jobs[job_id].state.terminal()):
                raise ValueError(f"job id {job_id!r} already active")

        evicted: list[Job] = []
        dep_cancelled: list[Job] = []
        admitted: list[Job] = []
        try:
            with self._lock:
                evicted, dep_cancelled = self._prune_locked()
                seq = next(self._seq)
                job_id = job_id or f"job-{seq:04d}"
                check_id()
                aft, dd = self._check_after(job_id, after, data_deps,
                                            self._jobs)
                if self.max_pending is not None:
                    deadline = (None if timeout is None
                                else time.time() + timeout)
                    while self._pending_locked() >= self.max_pending:
                        if not block:
                            raise QueueFull(
                                f"{self._pending_locked()} jobs pending "
                                f"(max_pending={self.max_pending})")
                        remaining = (None if deadline is None
                                     else deadline - time.time())
                        if remaining is not None and remaining <= 0:
                            raise QueueFull(
                                f"timed out after {timeout}s waiting for "
                                f"queue capacity")
                        self._capacity.wait(remaining)
                        check_id()
                        # upstreams may have been evicted while blocked
                        aft, dd = self._check_after(job_id, aft, dd,
                                                    self._jobs)
                job = Job(job_id, process_list, priority=priority, seq=seq,
                          metadata=dict(metadata or {}),
                          trace_id=trace_id or "")
                self._jobs[job_id] = job
                heapq.heappush(self._heap, (-priority, seq, job))
                dep_cancelled.extend(self._wire_deps_locked(job, aft, dd))
                admitted.append(job)
                self._not_empty.notify()
                return job
        finally:
            # hooks (broker spool GC, metrics) do I/O — never under the
            # queue lock, and even when admission raises
            self._emit_submitted(admitted)
            self._fire_evict_hooks(evicted)
            self._fire_terminal_hooks(dep_cancelled)

    def submit_many(self, process_lists: list[ProcessList], *,
                    priority: int = 0,
                    job_ids: list[str] | None = None,
                    metadatas: list[dict[str, Any]] | None = None,
                    afters: list[list[str]] | None = None,
                    data_deps: list[list[str]] | None = None
                    ) -> list[Job]:
        """Admit a GROUP of process lists atomically — all admitted, or
        nothing is.  The jobs get consecutive ``seq`` numbers under one
        lock hold, so no other submission (or dispatch) interleaves: a
        gang-batching pop sees the whole group together.  This is the
        parameter-sweep admission path (``service.sweep``) and
        the workflow-DAG admission path (``service.workflow``):
        ``afters`` may reference ids WITHIN the group (in any order —
        acyclicity is the workflow layer's contract), so a whole DAG
        lands in one atomic call.

        Args:
            process_lists: the chains, in variant order.
            priority: shared by every member (a sweep is one workload).
            job_ids: explicit ids, same length (default ``job-{seq}``).
            metadatas: per-job annotations, same length.
            afters: per-job upstream id lists (see :meth:`submit`).
            data_deps: per-job result-consuming upstream id lists.

        Returns: the queued Jobs, in input order.
        Raises:
            QueueFull: the WHOLE group would exceed ``max_pending`` —
                nothing was admitted.
            ValueError: a job id is already active (or duplicated within
                the group), or an ``afters`` entry names an unknown
                upstream — nothing was admitted.
        """
        n = len(process_lists)
        if job_ids is not None and len(job_ids) != n:
            raise ValueError(f"{len(job_ids)} job_ids for {n} jobs")
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(f"{len(metadatas)} metadatas for {n} jobs")
        if afters is not None and len(afters) != n:
            raise ValueError(f"{len(afters)} afters for {n} jobs")
        if data_deps is not None and len(data_deps) != n:
            raise ValueError(f"{len(data_deps)} data_deps for {n} jobs")
        evicted: list[Job] = []
        dep_cancelled: list[Job] = []
        admitted: list[Job] = []
        try:
            with self._lock:
                evicted, dep_cancelled = self._prune_locked()
                if self.max_pending is not None and \
                        self._pending_locked() + n > self.max_pending:
                    raise QueueFull(
                        f"group of {n} would exceed max_pending="
                        f"{self.max_pending} ({self._pending_locked()} "
                        f"already pending)")
                if job_ids is not None:
                    if len(set(job_ids)) != n:
                        raise ValueError(
                            "duplicate job ids within the group")
                    for jid in job_ids:
                        if jid in self._jobs and \
                                not self._jobs[jid].state.terminal():
                            raise ValueError(
                                f"job id {jid!r} already active")
                # dependency ids may point at existing jobs OR group
                # members; validate EVERYTHING before inserting anything
                # (all-or-nothing admission)
                deps: list[tuple] = []
                if afters is not None or data_deps is not None:
                    known = set(self._jobs) | set(job_ids or ())
                    for i in range(n):
                        jid = job_ids[i] if job_ids is not None else None
                        deps.append(self._check_after(
                            jid, (afters or [()] * n)[i],
                            (data_deps or [()] * n)[i], known))
                jobs = []
                for i, pl in enumerate(process_lists):
                    seq = next(self._seq)
                    jid = job_ids[i] if job_ids is not None \
                        else f"job-{seq:04d}"
                    job = Job(jid, pl, priority=priority, seq=seq,
                              metadata=dict((metadatas or [{}] * n)[i]))
                    self._jobs[jid] = job
                    heapq.heappush(self._heap, (-priority, seq, job))
                    jobs.append(job)
                # wire deps only once every member exists, so in-group
                # references resolve regardless of declaration order
                for job, (aft, dd) in zip(jobs, deps):
                    dep_cancelled.extend(
                        self._wire_deps_locked(job, aft, dd))
                admitted.extend(jobs)
                self._not_empty.notify_all()
                return jobs
        finally:
            self._emit_submitted(admitted)
            self._fire_evict_hooks(evicted)
            self._fire_terminal_hooks(dep_cancelled)

    # -- dispatch -------------------------------------------------------
    def _pop_locked(self, predicate: Callable[[Job], bool] | None = None
                    ) -> Job | None:
        # Eligibility-filtered pop: scan the FULL dispatch order
        # (-priority, seq) and take the first eligible queued job —
        # with its dependencies satisfied (:meth:`Job.deps_ready`: a
        # DAG downstream keeps its queue position until every upstream
        # is DONE), matching the capability ``predicate`` AND, for
        # streaming jobs,
        # with work available (:meth:`Job.stream_ready`: a frame-starved
        # streaming job keeps its queue position without burning a
        # dispatch slot or lease until frames/EOF arrive and ``kick()``
        # re-wakes the waiters).  Non-eligible QUEUED jobs are left
        # exactly where they are: an unmatchable high-priority head
        # never shadows a matchable lower-priority job (we keep scanning
        # past it), and because skipped entries are not popped/re-pushed
        # their position — and FIFO fairness — is preserved for the
        # worker that CAN run them.  Terminal tombstones (cancelled
        # while queued) are discarded as the scan passes them.
        taken = None
        dead: list[tuple] = []
        for entry in sorted(self._heap, key=lambda e: (e[0], e[1])):
            job = entry[2]
            if job.state is not JobState.QUEUED:
                dead.append(entry)
                continue
            if job.deps_ready() and job.stream_ready() \
                    and (predicate is None or predicate(job)):
                job.state = JobState.CHECKING
                taken = entry
                break
        if taken is not None:
            dead.append(taken)
        if dead:
            drop = {id(e) for e in dead}
            self._heap = [e for e in self._heap if id(e) not in drop]
            heapq.heapify(self._heap)
        return None if taken is None else taken[2]

    def kick(self) -> None:
        """Wake every blocked :meth:`get`/:meth:`get_batch` caller so it
        re-evaluates job eligibility — called by the ingest endpoints
        when frames or EOF arrive for a parked streaming job (its
        ``stream_ready()`` may just have flipped to True)."""
        with self._lock:
            self._not_empty.notify_all()

    def get(self, timeout: float | None = None,
            predicate: Callable[[Job], bool] | None = None) -> Job | None:
        """Pop the highest-priority queued job (None on timeout).

        Args:
            timeout: seconds to wait for a (matching) job; None = forever.
            predicate: capability filter — only jobs it accepts are
                eligible; non-matching jobs keep their queue position
                (see :meth:`_pop_locked` for the starvation guarantee).
        """
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                job = self._pop_locked(predicate)
                if job is not None:
                    return job
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)

    def get_batch(self, max_jobs: int, timeout: float | None = None,
                  match: Callable[[Job, Job], bool] | None = None,
                  predicate: Callable[[Job], bool] | None = None
                  ) -> list[Job]:
        """Pop the head job plus up to ``max_jobs - 1`` queued jobs with
        an identical chain signature (gang scheduling).  Candidates are
        scanned in dispatch order — sorted ``(-priority, seq)``, not raw
        heap-array order — so gang members join by priority then FIFO
        and a truncated gang takes the jobs whose turn it actually is.
        ``predicate`` restricts both the head and the gang members to
        jobs a capability-filtered worker can run (lease path).
        Streaming jobs never gang — their pace is set by frame arrival,
        not by the compiled step loop — so a streaming head pops solo
        and streaming members are skipped."""
        head = self.get(timeout, predicate)
        if head is None:
            return []
        if head.streaming:
            return [head]
        match = match or (lambda a, b: a.chain_sig == b.chain_sig)
        batch = [head]
        with self._lock:
            for entry in sorted(self._heap, key=lambda e: (e[0], e[1])):
                if len(batch) >= max_jobs:
                    break
                job = entry[2]
                if job.state is JobState.QUEUED and not job.streaming \
                        and job.deps_ready() and match(head, job) \
                        and (predicate is None or predicate(job)):
                    job.state = JobState.CHECKING
                    batch.append(job)
            if len(batch) > 1:
                taken = {id(j) for j in batch}
                self._heap = [e for e in self._heap
                              if id(e[2]) not in taken]
                heapq.heapify(self._heap)
        return batch

    def requeue(self, job: Job) -> bool:
        """Put a dispatched (leased) job back in the queue — the broker's
        lease-expiry path.  The job keeps its original ``seq``, so it
        re-enters at the FRONT of its priority class (it is the oldest
        submission there) and resumes promptly on the next capable
        worker.  Returns False (and does nothing) for terminal jobs."""
        with self._lock:
            if job.state.terminal() or job.state is JobState.QUEUED:
                return False
            job.state = JobState.QUEUED
            job.requeued_at = time.time()
            heapq.heappush(self._heap, (-job.priority, job.seq, job))
            self._not_empty.notify()
            return True

    # -- bookkeeping ----------------------------------------------------
    def job(self, job_id: str) -> Job:
        """Look up a job by id.  Raises KeyError if unknown (or already
        evicted by ``max_history``)."""
        with self._lock:
            return self._jobs[job_id]

    def cancel(self, job_id: str) -> bool:
        """Cancel a job that has not been dispatched yet.

        Returns:
            True — the job was QUEUED and is now CANCELLED (terminal;
            it will never execute, and blocked submitters are woken).
            False — unknown id, already dispatched (a worker owns it),
            or already terminal.  The refusal never mutates the job, so
            a cancel racing a dispatch resolves to exactly one winner.
        """
        cancelled: list[Job] = []
        try:
            with self._lock:
                job = self._jobs.get(job_id)
                if job is None or job.state is not JobState.QUEUED:
                    return False
                job.state = JobState.CANCELLED
                job.cancel_reason = job.cancel_reason or "user"
                job.finished_at = time.time()
                cancelled = [job] + self._propagate_terminal_locked(job)
                self._capacity.notify_all()
                return True
        finally:
            self._fire_terminal_hooks(cancelled)

    def notify_terminal(self, job: Job | None = None) -> None:
        """Scheduler/broker hook: a job reached a terminal state — wake
        blocked submitters (admission capacity freed) and, when the
        terminal ``job`` is passed, resolve the dependency graph:
        a DONE upstream releases its downstream fan-out edges, a
        failed/cancelled one cascade-cancels the downstream cone (the
        cascaded jobs fire the terminal hooks)."""
        cancelled: list[Job] = []
        with self._lock:
            # the guard matters: expiry paths notify with a job they
            # just REQUEUED — propagating a non-terminal job would
            # cascade-cancel a perfectly live downstream cone
            if job is not None and job.state.terminal():
                cancelled = self._propagate_terminal_locked(job)
            self._capacity.notify_all()
        self._fire_terminal_hooks(cancelled)

    def pending(self) -> int:
        """Number of non-terminal jobs (what admission control counts)."""
        with self._lock:
            return self._pending_locked()

    def queue_info(self) -> dict[str, Any]:
        """Starvation visibility (``GET /stats`` ``queue`` block): depth
        of still-QUEUED jobs, per-priority breakdown, and the oldest
        queued job's id + age since submission — the number that grows
        when the service is overloaded or a job is unmatchable."""
        now = time.time()
        with self._lock:
            queued = [j for j in self._jobs.values()
                      if j.state is JobState.QUEUED]
            by_priority: dict[str, int] = {}
            for j in queued:
                key = str(j.priority)
                by_priority[key] = by_priority.get(key, 0) + 1
            oldest = min(queued, key=lambda j: j.submitted_at,
                         default=None)
            return {
                "depth": len(queued),
                "by_priority": by_priority,
                "oldest_pending_job": (None if oldest is None
                                       else oldest.job_id),
                "oldest_pending_age": (None if oldest is None else
                                       round(now - oldest.submitted_at,
                                             6)),
            }

    def snapshot(self) -> list[dict[str, Any]]:
        """Every retained job's ``Job.snapshot()``, submission-ordered
        (``GET /jobs``)."""
        with self._lock:
            return [j.snapshot() for j in
                    sorted(self._jobs.values(), key=lambda j: j.seq)]

    def wait_all(self, timeout: float | None = None,
                 poll: float = 0.02) -> bool:
        """Block until every submitted job is terminal.  True on success,
        False on timeout."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                if all(j.state.terminal() for j in self._jobs.values()):
                    return True
            if deadline is not None and time.time() >= deadline:
                return False
            time.sleep(poll)
