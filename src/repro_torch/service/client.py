"""PipelineClient — stdlib HTTP client for the pipeline service.

The submit side of cross-process serving: build a process list locally
(or load a spec JSON), ``submit`` it, ``wait`` on the polling loop,
``result`` the reconstruction back as numpy.  Wraps every endpoint of
:mod:`.server`; errors carry the server's validation message
(:class:`ServiceError.status` / ``.message``).

The port's copy of ``repro.service.client`` (stdlib and numpy; it
speaks to the JAX package's service and the port's alike).  The
worker-protocol methods are plain HTTP calls; the port's service in
local mode answers them 409, as the JAX package's does.

    >>> client = PipelineClient("http://127.0.0.1:8973")
    >>> job_id = client.submit(standard_chain(n_det=48), priority=2)
    >>> client.wait(job_id, timeout=120)["status"]
    'done'
    >>> recon = client.result(job_id)        # np.ndarray
"""
from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from typing import Any
from urllib.parse import quote

import numpy as np

from ..core.process_list import ProcessList
from .wire import to_spec

_TERMINAL = ("done", "failed", "cancelled")


class ServiceError(RuntimeError):
    """An HTTP endpoint answered with an error status.

    Attributes:
        status: the HTTP status code (400 validation, 404 unknown,
            409 conflict, 429 admission rejection, ...).
        message: the server's ``error`` body field.
        detail: the full parsed JSON error body when the server sent
            one (e.g. the 503 readiness reply's ``firing`` list),
            else None.
    """

    def __init__(self, status: int, message: str,
                 detail: dict[str, Any] | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        self.detail = detail


class PipelineClient:
    def __init__(self, base_url: str, timeout: float = 30.0,
                 token: str | None = None):
        """Args:
            base_url: e.g. ``http://127.0.0.1:8973`` (no trailing slash
                needed).
            timeout: per-request socket timeout in seconds.
            token: shared secret for a token-armed server — sent as
                ``Authorization: Bearer <token>`` on every request
                (mutating verbs are 401 without it).
        """
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        # per-worker secrets minted by POST /workers, keyed by worker_id
        # (one client may drive several registered workers — tests do);
        # attached automatically to lease/progress/complete/uploads
        self._worker_secrets: dict[str, str] = {}

    # -- transport ------------------------------------------------------
    def _request(self, method: str, path: str,
                 body: dict | None = None, raw: bool = False,
                 raw_body: bytes | None = None,
                 headers: dict[str, str] | None = None,
                 with_headers: bool = False) -> Any:
        if raw_body is not None:
            data = raw_body
            hdrs = {"Content-Type": "application/octet-stream"}
        else:
            data = None if body is None else json.dumps(body).encode()
            hdrs = {"Content-Type": "application/json"} if data else {}
        if self.token is not None:
            hdrs["Authorization"] = f"Bearer {self.token}"
        hdrs.update(headers or {})
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
                resp_headers = dict(resp.headers)
        except urllib.error.HTTPError as e:
            raw = e.read()
            parsed: dict[str, Any] | None = None
            try:
                parsed = json.loads(raw)
                message = parsed["error"]
            except (json.JSONDecodeError, KeyError, TypeError):
                message = raw.decode(errors="replace") or e.reason
                parsed = parsed if isinstance(parsed, dict) else None
            raise ServiceError(e.code, message, detail=parsed) from None
        out = payload if raw else json.loads(payload)
        return (out, resp_headers) if with_headers else out

    # -- endpoints ------------------------------------------------------
    def submit(self, process_list: ProcessList | dict | list, *,
               priority: int = 0, job_id: str | None = None,
               metadata: dict | None = None) -> str:
        """Submit a process list (``POST /jobs``).

        Args:
            process_list: a :class:`ProcessList` (serialised via
                :func:`~.wire.to_spec`) or an
                already-serialised spec document.
            priority: higher pops first (FIFO within a priority).
            job_id: explicit id — reuse the id of a killed job to
                resume it from its checkpoint.
            metadata: free-form JSON-able annotations.

        Returns: the job id.
        Raises:
            ServiceError: 400 invalid spec, 409 duplicate active id,
                429 admission control rejected (shed load and retry).
        """
        if isinstance(process_list, ProcessList):
            process_list = to_spec(process_list)
        envelope: dict[str, Any] = {"process_list": process_list,
                                    "priority": priority}
        if job_id is not None:
            envelope["job_id"] = job_id
        if metadata:
            envelope["metadata"] = metadata
        return self._request("POST", "/jobs", envelope)["job_id"]

    def status(self, job_id: str) -> dict[str, Any]:
        """One job's ``Job.snapshot()`` (``GET /jobs/{id}``): state,
        ``running(plugin i/N)`` progress, ``resumed_from``, timings.
        Raises ServiceError(404) for an unknown/pruned job."""
        return self._request("GET", f"/jobs/{quote(job_id, safe='')}")

    def jobs(self) -> list[dict[str, Any]]:
        """Every job's snapshot, submission-ordered (``GET /jobs``)."""
        return self._request("GET", "/jobs")["jobs"]

    def stats(self) -> dict[str, Any]:
        """Scheduler + compile-cache counters (``GET /stats``)."""
        return self._request("GET", "/stats")

    def trace(self, job_id: str, text: bool = False,
              otlp: bool = False) -> dict[str, Any] | str:
        """A job's cross-process span timeline
        (``GET /jobs/{id}/trace``): ``{"job_id", "trace_id",
        "spans": [...]}`` — or, with ``text=True``, the ASCII gantt
        rendering (``?format=text``), or, with ``otlp=True``, the
        OTLP/JSON export document (``?format=otlp``).  Raises
        ServiceError(404) for an unknown/pruned job.  See
        ``docs/observability.md``."""
        path = f"/jobs/{quote(job_id, safe='')}/trace"
        if text:
            return self._request("GET", path + "?format=text",
                                 raw=True).decode()
        if otlp:
            return self._request("GET", path + "?format=otlp")
        return self._request("GET", path)

    def metrics(self) -> str:
        """The Prometheus text exposition (``GET /metrics``) — the same
        numbers as ``stats()["metrics"]``, scrape-ready."""
        return self._request("GET", "/metrics", raw=True).decode()

    def plugins(self) -> dict[str, Any]:
        """The wire-format plugin registry (``GET /plugins``)."""
        return self._request("GET", "/plugins")

    def health(self, ready: bool = False) -> dict[str, Any]:
        """Liveness probe (``GET /healthz``).  With ``ready=True`` asks
        the degrade-aware readiness question (``?ready=1``): while a
        critical SLO rule fires the server answers 503 — returned here
        as its machine-readable detail (``{"ok": False, "ready":
        False, "firing": [...], ...}``) rather than raised, so callers
        branch on ``out["ready"]``."""
        if not ready:
            return self._request("GET", "/healthz")
        try:
            return self._request("GET", "/healthz?ready=1")
        except ServiceError as e:
            if e.status == 503 and e.detail is not None:
                return e.detail
            raise

    def slo(self) -> dict[str, Any]:
        """The SLO engine snapshot (``GET /slo``): every rule's
        definition, current reading and lifecycle state, plus the
        ``firing`` / ``critical_firing`` summaries.  The scrape
        evaluates first, so states are never stale."""
        return self._request("GET", "/slo")

    def events(self, since: int = 0,
               limit: int | None = None) -> dict[str, Any]:
        """A structured event-log page (``GET /events``): records with
        ``seq > since`` oldest-first, the new ``cursor`` to resume
        from, and how many records the bounded ring ``dropped`` before
        this cursor.  Poll with the returned cursor to tail."""
        q = f"?since={int(since)}"
        if limit is not None:
            q += f"&limit={int(limit)}"
        return self._request("GET", "/events" + q)

    def cluster(self) -> dict[str, Any]:
        """The per-worker scoreboard (``GET /cluster``; broker mode —
        409 otherwise): heartbeat staleness, active leases with
        time-to-expiry, last error, warm-pool prefetch count."""
        return self._request("GET", "/cluster")

    def cancel(self, job_id: str) -> dict[str, Any]:
        """Cancel a queued job (``DELETE /jobs/{id}``).

        Returns: ``{"cancelled": True, ...}`` on success.
        Raises:
            ServiceError: 404 unknown job; 409 the job was already
                dispatched or terminal (body names its state).
        """
        return self._request("DELETE", f"/jobs/{quote(job_id, safe='')}")

    def result(self, job_id: str, dataset: str | None = None
               ) -> np.ndarray:
        """Fetch an output dataset (``GET /jobs/{id}/result``) as a
        numpy array (npy bytes on the wire, chunk-streamed server-side).

        Args:
            dataset: dataset name; default = the chain's saver output.

        Raises:
            ServiceError: 404 unknown job/dataset or evicted result,
                409 the job is not done yet.
        """
        q = f"?dataset={quote(dataset, safe='')}" if dataset else ""
        payload = self._request(
            "GET", f"/jobs/{quote(job_id, safe='')}/result{q}", raw=True)
        return np.load(io.BytesIO(payload))

    # -- streaming acquisition (docs/streaming.md) -----------------------
    def ingest(self, job_id: str, frames: np.ndarray,
               start: int) -> dict[str, Any]:
        """Feed one contiguous frame chunk to a streaming job
        (``POST /jobs/{id}/frames``; frames on axis 0, raw ``.npy`` on
        the wire).  ``start`` must equal the current watermark.

        Returns: ``{"start", "count", "watermark"}``.
        Raises:
            ServiceError: 404 unknown job; 409 not a streaming job,
                out-of-order/duplicate chunk, after EOF, or terminal.
        """
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(frames))
        return self._request(
            "POST", f"/jobs/{quote(job_id, safe='')}/frames",
            raw_body=buf.getvalue(),
            headers={"X-Start-Frame": str(int(start))})

    def eof(self, job_id: str) -> dict[str, Any]:
        """Declare end of acquisition (``POST /jobs/{id}/eof``).
        Raises ServiceError 409 on a second EOF or a non-streaming
        job."""
        return self._request(
            "POST", f"/jobs/{quote(job_id, safe='')}/eof", body={})

    def preview(self, job_id: str) -> tuple[np.ndarray, int]:
        """The partial reconstruction over the frames ingested so far
        (``GET /jobs/{id}/preview``) as ``(array, frames_covered)``.
        Raises ServiceError 409 while no preview can be produced yet."""
        payload, hdrs = self._request(
            "GET", f"/jobs/{quote(job_id, safe='')}/preview",
            raw=True, with_headers=True)
        return (np.load(io.BytesIO(payload)),
                int(hdrs.get("X-Watermark", 0)))

    def fetch_frames(self, job_id: str, start: int = 0,
                     max_frames: int | None = None
                     ) -> tuple[np.ndarray | None, int, bool, int]:
        """Pull buffered frames from ``start`` on
        (``GET /jobs/{id}/frames``) — how a broker-mode worker consumes
        the stream.  Returns ``(frames | None, start, eof, watermark)``;
        frames is None when nothing at-or-after ``start`` has arrived."""
        q = f"?start={int(start)}"
        if max_frames is not None:
            q += f"&max={int(max_frames)}"
        payload, hdrs = self._request(
            "GET", f"/jobs/{quote(job_id, safe='')}/frames{q}",
            raw=True, with_headers=True)
        eof = hdrs.get("X-EOF") == "1"
        watermark = int(hdrs.get("X-Watermark", 0))
        if not payload or hdrs.get("X-Count") == "0":
            return None, int(start), eof, watermark
        return (np.load(io.BytesIO(payload)),
                int(hdrs.get("X-Start", start)), eof, watermark)

    # -- parameter sweeps (docs/sweeps.md) -------------------------------
    def sweep(self, process_list: ProcessList | dict | list,
              sweep: dict | list, *, metric: str | None = None,
              priority: int = 0, sweep_id: str | None = None,
              metadata: dict | None = None) -> dict[str, Any]:
        """Submit a parameter sweep (``POST /sweeps``): the process list
        plus a grid block over ≤2 *sweepable* params, expanded
        server-side into gang-batched variant jobs.

        Args:
            process_list: a :class:`ProcessList` or spec document.
            sweep: one axis (``{"plugin": name | "plugin_index": i,
                "param": p, "values": [...]}``) or a list of ≤2.
            metric: optional per-variant score (``sharpness`` /
                ``entropy`` / ``std``) — surfaces ``best_variant``.
            priority: shared by every variant.
            sweep_id: explicit group id (variants are ``{id}/v{k}``).
            metadata: annotations copied onto every variant.

        Returns: the submission reply — ``sweep_id``, ``n_variants``,
        ``shape``, ``job_ids``.
        Raises:
            ServiceError: 400 invalid spec/sweep (non-sweepable param,
                >2 axes, unknown metric...), 409 duplicate active id,
                429 the whole group was rejected by admission control.
        """
        if isinstance(process_list, ProcessList):
            process_list = to_spec(process_list)
        envelope: dict[str, Any] = {"process_list": process_list,
                                    "sweep": sweep, "priority": priority}
        if metric is not None:
            envelope["metric"] = metric
        if sweep_id is not None:
            envelope["sweep_id"] = sweep_id
        if metadata:
            envelope["metadata"] = metadata
        return self._request("POST", "/sweeps", envelope)

    def sweep_status(self, sweep_id: str) -> dict[str, Any]:
        """One sweep group's snapshot (``GET /sweeps/{id}``): aggregate
        state, per-variant snapshots with their grid values, scores +
        ``best_variant`` once done (when a metric was requested)."""
        return self._request("GET",
                             f"/sweeps/{quote(sweep_id, safe='')}")

    def sweeps(self) -> list[dict[str, Any]]:
        """Every retained sweep group's summary (``GET /sweeps``)."""
        return self._request("GET", "/sweeps")["sweeps"]

    def sweep_result(self, sweep_id: str, dataset: str | None = None
                     ) -> np.ndarray:
        """Fetch the stacked result (``GET /sweeps/{id}/result``): shape
        ``(*grid_shape, *variant_shape)`` — the parameter axes lead.
        Raises ServiceError 404 (unknown) / 409 (not all done)."""
        q = f"?dataset={quote(dataset, safe='')}" if dataset else ""
        payload = self._request(
            "GET", f"/sweeps/{quote(sweep_id, safe='')}/result{q}",
            raw=True)
        return np.load(io.BytesIO(payload))

    def cancel_sweep(self, sweep_id: str) -> dict[str, Any]:
        """Cancel every live variant (``DELETE /sweeps/{id}``).  Returns
        the per-variant ``cancelled``/``skipped`` id lists."""
        return self._request("DELETE",
                             f"/sweeps/{quote(sweep_id, safe='')}")

    def wait_sweep(self, sweep_id: str, timeout: float | None = None,
                   poll: float = 0.1) -> dict[str, Any]:
        """Block until every variant is terminal.  Returns the final
        group snapshot (inspect ``snapshot["state"]`` — done / failed /
        cancelled / partial).  Raises TimeoutError at the deadline."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            snap = self.sweep_status(sweep_id)
            if snap["all_terminal"]:
                return snap
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"sweep {sweep_id!r} still {snap['state']!r} "
                    f"({snap['counts']}) after {timeout}s")
            time.sleep(poll)

    # -- workflow DAGs (docs/workflows.md) -------------------------------
    def workflow(self, nodes: dict[str, Any], *,
                 workflow_id: str | None = None, priority: int = 0,
                 metadata: dict | None = None) -> dict[str, Any]:
        """Submit a DAG of process lists as ONE spec-v3 envelope
        (``POST /workflows``): each node is a process list, ``after``
        lists upstream node names, and an ``upstream_loader`` entry with
        ``{"data": {"from_job": "<node>", "dataset": "<name>"}}`` feeds
        a node an upstream output (the reference also implies the edge).

        Args:
            nodes: ``{name: ProcessList}`` or ``{name:
                {"process_list": ProcessList | spec,
                 "after": [upstream names], "priority": int}}``.
            workflow_id: explicit group id (node jobs are
                ``{id}/{node}``).
            priority: default for nodes that set none.
            metadata: annotations copied onto every node job.

        Returns: the submission reply — ``workflow_id``, ``state``,
        ``n_nodes``, ``nodes`` (topological order), ``job_ids``.
        Raises:
            ServiceError: 400 invalid envelope (cycle, dangling
                reference, bad spec — NOTHING was enqueued), 409
                duplicate active id, 429 the whole DAG was rejected by
                admission control.
        """
        wf: dict[str, Any] = {}
        for name, node in nodes.items():
            if isinstance(node, ProcessList):
                node = {"process_list": node}
            node = dict(node)
            if isinstance(node.get("process_list"), ProcessList):
                node["process_list"] = to_spec(node["process_list"])
            wf[name] = node
        envelope: dict[str, Any] = {"version": 3, "workflow": wf,
                                    "priority": priority}
        if workflow_id is not None:
            envelope["workflow_id"] = workflow_id
        if metadata:
            envelope["metadata"] = metadata
        return self._request("POST", "/workflows", envelope)

    def workflow_status(self, workflow_id: str) -> dict[str, Any]:
        """One workflow's snapshot (``GET /workflows/{id}``): aggregate
        state, per-state counts, the DAG edges, and per-node job
        snapshots (``waiting_on``, ``cancel_reason``...) keyed by node
        name."""
        return self._request(
            "GET", f"/workflows/{quote(workflow_id, safe='')}")

    def workflows(self) -> list[dict[str, Any]]:
        """Every retained workflow's summary (``GET /workflows``)."""
        return self._request("GET", "/workflows")["workflows"]

    def workflow_trace(self, workflow_id: str) -> dict[str, Any]:
        """The workflow-level linked trace
        (``GET /workflows/{id}/trace``): per-node span timelines keyed
        by node name, plus the DAG edges that connect them."""
        return self._request(
            "GET", f"/workflows/{quote(workflow_id, safe='')}/trace")

    def cancel_workflow(self, workflow_id: str) -> dict[str, Any]:
        """Cancel every live node (``DELETE /workflows/{id}``).  Queued
        nodes cancel immediately and their downstream cones cascade;
        returns the ``cancelled``/``skipped`` id lists."""
        return self._request(
            "DELETE", f"/workflows/{quote(workflow_id, safe='')}")

    def wait_workflow(self, workflow_id: str,
                      timeout: float | None = None,
                      poll: float = 0.1) -> dict[str, Any]:
        """Block until every node is terminal.  Returns the final group
        snapshot (inspect ``snapshot["state"]`` — done / failed /
        cancelled / partial).  Raises TimeoutError at the deadline."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            snap = self.workflow_status(workflow_id)
            if snap["all_terminal"]:
                return snap
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"workflow {workflow_id!r} still {snap['state']!r} "
                    f"({snap['counts']}) after {timeout}s")
            time.sleep(poll)

    # -- worker-pull protocol (broker mode; docs/worker-protocol.md) ----
    def register_worker(self, *, worker_id: str | None = None,
                        plugins: list[str] | None = None,
                        mesh_shape: list[int] | None = None,
                        max_batch: int = 1,
                        shared_fs: bool = False,
                        sweeps: bool = True,
                        device: str | None = None,
                        transport: str | None = None) -> dict[str, Any]:
        """Register a worker process (``POST /workers``) with its
        capabilities (``sweeps=False`` keeps the worker out of
        parameter-sweep fan-outs; ``device``, the card's name, and
        ``transport`` are sent only when given).  Returns
        ``{"worker_id", "worker_secret", "lease_ttl",
        "hot_executables"}`` (plus ``"results_dir"`` for shared-fs
        workers).  The minted ``worker_secret`` is remembered per
        worker_id and attached to every subsequent
        lease/progress/complete/upload automatically.  409 if the server
        is not in broker mode."""
        body: dict[str, Any] = {
            "worker_id": worker_id, "plugins": plugins,
            "mesh_shape": mesh_shape, "max_batch": max_batch,
            "shared_fs": shared_fs, "sweeps": sweeps}
        for k, v in (("device", device), ("transport", transport)):
            if v is not None:
                body[k] = v
        reply = self._request("POST", "/workers", body)
        if isinstance(reply.get("worker_secret"), str):
            self._worker_secrets[reply["worker_id"]] = \
                reply["worker_secret"]
        return reply

    def worker_secret(self, worker_id: str) -> str | None:
        """The per-worker secret minted at registration (None if this
        client never registered ``worker_id``)."""
        return self._worker_secrets.get(worker_id)

    def adopt_worker_secret(self, worker_id: str, secret: str) -> None:
        """Attach a secret minted elsewhere (e.g. by an in-process
        :class:`PipelineWorker`'s own client) so this client may act
        on that worker's behalf."""
        self._worker_secrets[worker_id] = secret

    def lease(self, worker_id: str, max_jobs: int = 1,
              timeout: float = 0.0,
              prefetched: int | None = None) -> list[dict[str, Any]]:
        """Lease capability-matching jobs (``POST /jobs/lease``).
        Returns the (possibly empty) job-descriptor list; ``timeout``
        long-polls server-side up to 30s.  ``prefetched`` reports how
        many warm-pool executables this worker holds — surfaced on the
        ``GET /cluster`` scoreboard."""
        body: dict[str, Any] = {
            "worker_id": worker_id, "max_jobs": max_jobs,
            "timeout": timeout,
            "worker_secret": self._worker_secrets.get(worker_id)}
        if prefetched is not None:
            body["prefetched"] = prefetched
        return self._request("POST", "/jobs/lease", body)["jobs"]

    def progress(self, job_id: str, worker_id: str,
                 **fields: Any) -> dict[str, Any]:
        """Heartbeat + progress for a leased job
        (``POST /jobs/{id}/progress``; fields: ``plugin_index``,
        ``n_plugins``, ``resumed_from``, ``checkpoint``).  The reply's
        ``verdict`` is ``ok`` / ``cancelled`` / ``lost``."""
        return self._request(
            "POST", f"/jobs/{quote(job_id, safe='')}/progress",
            {"worker_id": worker_id,
             "worker_secret": self._worker_secrets.get(worker_id),
             **fields})

    def complete(self, job_id: str, worker_id: str, state: str,
                 error: str | None = None,
                 results: dict[str, Any] | None = None,
                 **fields: Any) -> dict[str, Any]:
        """Report a leased job terminal (``POST /jobs/{id}/complete``).
        Raises ServiceError(409) if the lease was lost — the caller
        must discard its outcome."""
        body: dict[str, Any] = {
            "worker_id": worker_id,
            "worker_secret": self._worker_secrets.get(worker_id),
            "state": state, **fields}
        if error is not None:
            body["error"] = error
        if results is not None:
            body["results"] = results
        return self._request(
            "POST", f"/jobs/{quote(job_id, safe='')}/complete", body)

    def _worker_headers(self, worker_id: str) -> dict[str, str]:
        headers = {"X-Worker-Id": worker_id}
        secret = self._worker_secrets.get(worker_id)
        if secret is not None:
            headers["X-Worker-Secret"] = secret
        return headers

    def upload_result(self, job_id: str, worker_id: str, dataset: str,
                      payload: bytes) -> dict[str, Any]:
        """Upload one result dataset as raw ``.npy`` bytes
        (``PUT /jobs/{id}/result?dataset=``); only the lease holder may
        upload (409 otherwise; 403 on a bad worker secret)."""
        return self._request(
            "PUT",
            f"/jobs/{quote(job_id, safe='')}/result"
            f"?dataset={quote(dataset, safe='')}",
            raw_body=payload, headers=self._worker_headers(worker_id))

    # -- executable warm pool (docs/worker-protocol.md) -----------------
    def hot_executables(self) -> list[str]:
        """The broker spool's hottest executable signatures
        (``GET /executables``) — what a fresh worker prefetches."""
        return self._request("GET", "/executables")["hot"]

    def fetch_executable(self, sig: str) -> bytes:
        """One serialized executable's raw payload
        (``GET /executables/{sig}``).  Raises ServiceError(404) when
        the spool doesn't have it."""
        return self._request("GET", f"/executables/{quote(sig, safe='')}",
                             raw=True)

    def upload_executable(self, sig: str, worker_id: str,
                          payload: bytes) -> dict[str, Any]:
        """Hand one serialized executable to the broker spool
        (``PUT /executables/{sig}``); registered workers only (403 on a
        bad secret, 400 on an unframed payload)."""
        return self._request(
            "PUT", f"/executables/{quote(sig, safe='')}",
            raw_body=payload, headers=self._worker_headers(worker_id))

    def workers(self) -> dict[str, Any]:
        """Per-worker broker stats (``GET /workers``; broker mode)."""
        return self._request("GET", "/workers")

    def wait(self, job_id: str, timeout: float | None = None,
             poll: float = 0.1) -> dict[str, Any]:
        """Block until ``job_id`` reaches a terminal state (the
        client-side poll loop over :meth:`status`).

        Args:
            timeout: seconds before giving up (None = forever).
            poll: seconds between polls.

        Returns: the terminal snapshot (state done/failed/cancelled —
        inspect ``snapshot["state"]``; a failed job's message is in
        ``snapshot["error"]``).
        Raises:
            TimeoutError: still non-terminal at the deadline.
        """
        deadline = None if timeout is None else time.time() + timeout
        while True:
            snap = self.status(job_id)
            if snap["state"] in _TERMINAL:
                return snap
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"job {job_id!r} still {snap['status']!r} after "
                    f"{timeout}s")
            time.sleep(poll)
