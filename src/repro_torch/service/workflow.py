"""Workflow DAGs — jobs that depend on jobs (docs/workflows.md).

Savu chains plugins inside ONE process list; a beamline campaign chains
*jobs*: recon feeds downsampling feeds quantification, each stage a
process list of its own (Ot2Rec's staged projects, Daisy's multi-stage
X-ray workflows).  The service layer makes that a first-class workload:

* a spec-v3 envelope (``POST /workflows``) names a DAG of nodes, each
  carrying a v1/v2 process-list spec plus ``"after"`` edges;
* admission is **atomic** (``JobQueue.submit_many``) after cycle and
  dangling-reference detection — an invalid DAG is rejected with 400
  and NOTHING is enqueued;
* stage outputs are addressable as downstream inputs: an
  ``upstream_loader`` entry referencing ``{"from_job": "<node>",
  "dataset": "<name>"}`` is rewritten to the node's job id here and
  resolved at dispatch/lease time by the scheduler or broker;
* downstream nodes become poppable only when every upstream is
  terminal-ok; upstream failure/cancellation cascades ``cancelled``
  with a machine-readable reason (``JobQueue`` owns the propagation).

Envelope::

    {"version": 3,
     "workflow": {
       "recon":      {"process_list": {spec v1}},
       "downsample": {"process_list": {... upstream_loader
                                       {"from_job": "recon"} ...}},
       "quantify":   {"process_list": {...},
                      "after": ["downsample"]}},
     "workflow_id": null, "priority": 0, "metadata": {}}

``after`` edges may be explicit, implied by upstream references, or
both; the union is validated.  See ``docs/workflows.md``.

The port's copy of ``repro.service.workflow`` (it holds no tensors; the
scheduler resolves a node's upstream result on the transport's device).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import threading
import time
from typing import Any, Callable

import torch

from ..core.plugin import _is_jsonable
from ..core.process_list import ProcessList
from .job import Job
from .queue import JobQueue
from .wire import WIRE_VERSION_WORKFLOW, from_spec

#: node-count bound per workflow — DAG validation is O(nodes + edges)
#: but every node is a whole pipeline job; admission control
#: (``max_pending``) applies on top
MAX_NODES = 32

#: node names become job-id components (``<workflow_id>/<node>``) and
#: path components in result spools: word chars, dots and dashes only
_NODE_NAME = re.compile(r"^[A-Za-z0-9_][\w.\-]*$")


class WorkflowError(ValueError):
    """A workflow envelope cannot be admitted: malformed document,
    invalid node name, dangling ``after``/upstream reference, self
    dependency, or a dependency cycle (HTTP 400)."""


def _entry_ref(params: dict[str, Any]) -> tuple[str, str | None] | None:
    """The ``(from_job, dataset)`` upstream reference of an entry's
    params, in either wire form, or None.  Mirrors the scheduler's
    resolver so validation and execution agree on what counts as a
    reference."""
    data = params.get("data")
    if isinstance(data, dict) and data.get("from_job"):
        return str(data["from_job"]), data.get("dataset")
    if data is not None or params.get("path"):
        return None
    fj = params.get("from_job")
    if fj:
        return str(fj), params.get("dataset")
    return None


def toposort(edges: dict[str, list[str]]) -> list[str]:
    """Kahn's algorithm over ``node -> upstream nodes``.  Returns one
    topological order (submission order used as the tiebreak so the
    queue's FIFO seq respects it).  Raises WorkflowError naming the
    cycle members when the graph is not a DAG."""
    indeg = {n: len(ups) for n, ups in edges.items()}
    down: dict[str, list[str]] = {n: [] for n in edges}
    for n, ups in edges.items():
        for u in ups:
            down[u].append(n)
    ready = [n for n, d in indeg.items() if d == 0]
    order: list[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for d in down[n]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(edges):
        cyclic = sorted(n for n, d in indeg.items() if d > 0)
        raise WorkflowError(
            f"workflow has a dependency cycle involving {cyclic}")
    return order


# ----------------------------------------------------------------------
@dataclasses.dataclass
class WorkflowGroup:
    """One admitted workflow: the node jobs plus the DAG bookkeeping."""

    workflow_id: str
    nodes: list[str]                    # submission (= topological) order
    jobs: list[Job]                     # parallel to ``nodes``
    edges: dict[str, list[str]]         # node -> upstream node names
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)

    @property
    def n_nodes(self) -> int:
        return len(self.jobs)

    def job_of(self, node: str) -> Job:
        return self.jobs[self.nodes.index(node)]

    def all_terminal(self) -> bool:
        return all(j.state.terminal() for j in self.jobs)

    def state(self) -> str:
        """Aggregate state: ``queued`` (nothing started) / ``running`` /
        all-terminal ``done`` | ``cancelled`` | ``failed`` (any node
        failed) | ``partial`` (mixed done+cancelled)."""
        states = {j.state.value for j in self.jobs}
        if not self.all_terminal():
            return "queued" if states == {"queued"} else "running"
        if states == {"done"}:
            return "done"
        if states == {"cancelled"}:
            return "cancelled"
        if "failed" in states:
            return "failed"
        return "partial"

    def snapshot(self, full: bool = True) -> dict[str, Any]:
        """JSON-able group view (``GET /workflows/{id}``): aggregate
        state, per-state counts, the DAG edges, and (``full``) one job
        snapshot per node keyed by node name."""
        counts: dict[str, int] = {}
        for j in self.jobs:
            counts[j.state.value] = counts.get(j.state.value, 0) + 1
        out: dict[str, Any] = {
            "workflow_id": self.workflow_id, "state": self.state(),
            "all_terminal": self.all_terminal(),
            "n_nodes": self.n_nodes, "nodes": list(self.nodes),
            "edges": {n: list(u) for n, u in self.edges.items()},
            "created_at": self.created_at, "counts": counts,
            "metadata": {k: v for k, v in self.metadata.items()
                         if _is_jsonable(v)},
        }
        if full:
            out["node_jobs"] = {n: j.snapshot()
                                for n, j in zip(self.nodes, self.jobs)}
        return out


# ----------------------------------------------------------------------
class WorkflowManager:
    """Validates spec-v3 envelopes into atomically-admitted node jobs
    and tracks them as :class:`WorkflowGroup`\\ s — the service-side
    owner of the ``/workflows`` endpoints.

    Args:
        queue: the admission queue node jobs are submitted to.
        max_nodes: per-workflow node bound (400 past it).
        max_history: retained terminal groups; beyond it the oldest
            all-terminal groups are dropped (their node jobs remain
            subject to the queue's own ``max_history``).
        device: where nodes compute, set on their loaders
            (:func:`~.wire.from_spec`); None keeps the spec's.
    """

    def __init__(self, queue: JobQueue, *, max_nodes: int = MAX_NODES,
                 max_history: int | None = 64,
                 device: str | torch.device | None = None):
        self.queue = queue
        self.device = device
        self.max_nodes = max_nodes
        self.max_history = max_history
        self._groups: dict[str, WorkflowGroup] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.workflows_submitted = 0
        self.nodes_submitted = 0

    # -- admission ------------------------------------------------------
    def submit(self, envelope: dict[str, Any]) -> WorkflowGroup:
        """Admit one workflow envelope (module docstring for the
        shape).  Validates every node's process list, the DAG structure
        (cycles, dangling references, self-dependencies), and submits
        all node jobs **atomically** — an invalid DAG enqueues nothing.

        Returns: the recorded :class:`WorkflowGroup`.
        Raises:
            WorkflowError / WireError / ProcessListError: invalid
                envelope, node spec, or DAG (HTTP 400).
            ValueError: duplicate active workflow/job id (HTTP 409).
            QueueFull: admission control rejected the whole group
                (HTTP 429).
        """
        if not isinstance(envelope, dict):
            raise WorkflowError("body must be a JSON object")
        version = envelope.get("version", WIRE_VERSION_WORKFLOW)
        if version != WIRE_VERSION_WORKFLOW:
            raise WorkflowError(
                f"workflow envelopes are spec v{WIRE_VERSION_WORKFLOW}, "
                f"got version {version!r}")
        nodes_spec = envelope.get("workflow", envelope.get("nodes"))
        if not isinstance(nodes_spec, dict) or not nodes_spec:
            raise WorkflowError(
                'body needs a non-empty "workflow" object mapping node '
                'names to {"process_list": ..., "after": [...]}')
        if len(nodes_spec) > self.max_nodes:
            raise WorkflowError(
                f"workflow has {len(nodes_spec)} nodes "
                f"(max_nodes={self.max_nodes})")
        priority = envelope.get("priority", 0)
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise WorkflowError(f"priority must be an integer, got "
                                f"{priority!r}")
        workflow_id = envelope.get("workflow_id")
        if workflow_id is not None and not isinstance(workflow_id, str):
            raise WorkflowError(f"workflow_id must be a string, got "
                                f"{workflow_id!r}")
        metadata = envelope.get("metadata") or {}
        if not isinstance(metadata, dict):
            raise WorkflowError("metadata must be an object")

        # -- per-node validation + edge collection ----------------------
        names = list(nodes_spec)
        pls: dict[str, ProcessList] = {}
        edges: dict[str, list[str]] = {}
        for name in names:
            if not isinstance(name, str) or not _NODE_NAME.match(name):
                raise WorkflowError(
                    f"node name {name!r} is invalid (it becomes a job-id "
                    f"component: letters/digits/._- only)")
            node = nodes_spec[name]
            if not isinstance(node, dict) or "process_list" not in node:
                raise WorkflowError(
                    f'node {name!r} must be an object with a '
                    f'"process_list"')
            pl = node["process_list"]
            if not isinstance(pl, ProcessList):
                pl = from_spec(pl, device=self.device)
            pl.check()
            pls[name] = pl
            after = node.get("after") or []
            if not isinstance(after, (list, tuple)) or \
                    not all(isinstance(a, str) for a in after):
                raise WorkflowError(
                    f'node {name!r}: "after" must be a list of node '
                    f"names, got {after!r}")
            ups = list(dict.fromkeys(after))
            # upstream-result references imply edges too
            for e in pl.entries:
                ref = _entry_ref(e.params)
                if ref is not None and ref[0] not in ups:
                    ups.append(ref[0])
            for u in ups:
                if u == name:
                    raise WorkflowError(
                        f"node {name!r} depends on itself")
                if u not in nodes_spec:
                    raise WorkflowError(
                        f"node {name!r} references unknown node {u!r} "
                        f"(nodes: {sorted(names)})")
            edges[name] = ups
        order = toposort(edges)

        with self._lock:
            self._prune_locked()
            if workflow_id is None:
                workflow_id = f"wf-{next(self._seq):04d}"
            existing = self._groups.get(workflow_id)
            if existing is not None and not existing.all_terminal():
                raise ValueError(
                    f"workflow id {workflow_id!r} already active")

        # -- rewrite node-name references to full job ids ---------------
        jid = {n: f"{workflow_id}/{n}" for n in names}
        data_deps: dict[str, list[str]] = {n: [] for n in names}
        for name in names:
            for e in pls[name].entries:
                ref = _entry_ref(e.params)
                if ref is None:
                    continue
                from_node, dataset = ref
                data_deps[name].append(jid[from_node])
                if isinstance(e.params.get("data"), dict):
                    e.params["data"] = {"from_job": jid[from_node],
                                        "dataset": dataset}
                else:
                    e.params["from_job"] = jid[from_node]

        metadatas = []
        for name in order:
            md = dict(metadata)
            md["workflow"] = {"workflow_id": workflow_id, "node": name,
                              "after": list(edges[name])}
            metadatas.append(md)
        jobs = self.queue.submit_many(
            [pls[n] for n in order], priority=priority,
            job_ids=[jid[n] for n in order], metadatas=metadatas,
            afters=[[jid[u] for u in edges[n]] for n in order],
            data_deps=[data_deps[n] for n in order])
        group = WorkflowGroup(workflow_id, list(order), jobs,
                              {n: list(edges[n]) for n in order},
                              metadata=dict(metadata))
        with self._lock:
            self._groups[workflow_id] = group
            self.workflows_submitted += 1
            self.nodes_submitted += len(jobs)
        return group

    def _prune_locked(self) -> None:
        if self.max_history is None:
            return
        terminal = [g for g in self._groups.values() if g.all_terminal()]
        terminal.sort(key=lambda g: g.created_at)
        for g in terminal[:max(0, len(terminal) - self.max_history)]:
            del self._groups[g.workflow_id]

    # -- lookup ----------------------------------------------------------
    def group(self, workflow_id: str) -> WorkflowGroup:
        """Raises KeyError for an unknown (or pruned) workflow id."""
        with self._lock:
            return self._groups[workflow_id]

    def status(self, workflow_id: str, full: bool = True
               ) -> dict[str, Any]:
        return self.group(workflow_id).snapshot(full=full)

    def snapshot_all(self) -> list[dict[str, Any]]:
        """Summary snapshot of every retained group (``GET
        /workflows``)."""
        with self._lock:
            groups = sorted(self._groups.values(),
                            key=lambda g: g.created_at)
        return [g.snapshot(full=False) for g in groups]

    # -- traces -----------------------------------------------------------
    def trace(self, workflow_id: str,
              fetch_trace: Callable[[str], dict[str, Any]]
              ) -> dict[str, Any]:
        """Workflow-level trace (``GET /workflows/{id}/trace``): one
        linked document with each node's span timeline keyed by node
        name.  ``fetch_trace`` is the service's per-job trace resolver
        (live trace or spool), so a workflow trace survives queue
        eviction exactly as long as its node traces do."""
        g = self.group(workflow_id)
        nodes = {}
        for name, job in zip(g.nodes, g.jobs):
            try:
                nodes[name] = fetch_trace(job.job_id)
            except KeyError:
                nodes[name] = None
        return {"workflow_id": workflow_id, "state": g.state(),
                "edges": {n: list(u) for n, u in g.edges.items()},
                "nodes": nodes}

    # -- cancellation -----------------------------------------------------
    def cancel(self, workflow_id: str,
               cancel_job: Callable[[str], dict[str, Any]]
               ) -> dict[str, Any]:
        """Cancel every live node via ``cancel_job`` (the service's
        per-job cancel: queued AND leased jobs).  Queued downstream
        nodes cascade automatically when their upstream cancels, so
        cancelling in topological order converges in one pass."""
        g = self.group(workflow_id)
        cancelled, skipped = [], []
        for j in g.jobs:
            if j.state.terminal():
                skipped.append(j.job_id)
                continue
            try:
                out = cancel_job(j.job_id)
            except KeyError:          # evicted mid-loop
                skipped.append(j.job_id)
                continue
            (cancelled if out.get("cancelled") else skipped).append(
                j.job_id)
        return {"workflow_id": workflow_id, "state": g.state(),
                "cancelled": cancelled, "skipped": skipped}

    def stats(self) -> dict[str, Any]:
        """Counters for ``GET /stats``: groups retained/active plus
        lifetime ``workflows_submitted`` / ``nodes_submitted``."""
        with self._lock:
            groups = list(self._groups.values())
            return {"workflows_submitted": self.workflows_submitted,
                    "nodes_submitted": self.nodes_submitted,
                    "groups": len(groups),
                    "active": sum(1 for g in groups
                                  if not g.all_terminal())}
