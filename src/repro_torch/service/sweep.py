"""Parameter sweeps — Savu's *parameter tuning* as a service workload.

Savu's headline usability feature: give a plugin parameter a LIST of
values and the framework re-runs that stage per value, adding an extra
dimension to the data so users can pick the best reconstruction
(classically the centre-of-rotation / filter cutoff for FBP).  The
service layer makes this fast at scale:

* a spec-v1 process list plus a ``sweep`` block (grid over ≤2
  *tunable* params) expands into a :class:`SweepGroup` of variant jobs
  whose chain signatures are IDENTICAL — tunables are excluded from
  both the chain signature and the compile-cache signature, their
  effect riding in ``jit_constants`` as runtime arguments;
* the variants are admitted **atomically** (``JobQueue.submit_many``),
  so the existing gang-batching scheduler pops them as one gang: each
  plugin step is ONE compiled call over every variant, and an N-point
  sweep compiles each plugin exactly once;
* group-level lifecycle rides over HTTP (``POST /sweeps``,
  ``GET /sweeps/{id}``, ``GET /sweeps/{id}/result`` — the stacked
  ``.npy`` with the parameter axis as the new leading dimension —
  ``DELETE /sweeps/{id}``), with an optional per-variant quality
  ``metric`` surfaced as ``best_variant``.

Sweep block (one axis, or a list of ≤2 for a grid)::

    {"process_list": {spec v1},
     "sweep": {"plugin": "sinogram_filter",   # or "plugin_index": 3
               "param": "cutoff",
               "values": [0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]},
     "metric": "sharpness"}

Only params a plugin declares in ``tunable_params`` (shown as
``sweepable`` in ``BasePlugin.param_spec()`` / ``GET /plugins``) may be
swept — anything else changes the compiled program and is rejected
loudly with the sweepable alternatives.  See ``docs/sweeps.md``.

The port's copy of ``repro.service.sweep``.  A variant's result is a
tensor where its job left it (on the card for a ``CudaTransport``): the
metrics score it with torch on that device and bring back one float, and
:meth:`SweepManager.result_plan` hands the server one variant at a time.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..core.plugin import _is_jsonable
from ..core.transport import ShardedTensor
from ..core.process_list import PluginEntry, ProcessList
from .job import Job
from .queue import JobQueue
from .wire import from_spec

#: grid dimensionality bound — Savu sweeps one or two params at a time
MAX_AXES = 2


class SweepError(ValueError):
    """A sweep request cannot be expanded: malformed block, unknown
    plugin/param, a non-sweepable param, too many axes/variants, or an
    unknown metric (HTTP 400)."""


# ----------------------------------------------------------------------
# metrics: per-variant quality scores over the result volume
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Metric:
    """A per-variant quality score.  ``best_variant`` maximises the
    score when ``higher_is_better`` else minimises it."""

    fn: Callable[[torch.Tensor | np.ndarray], float]
    higher_is_better: bool
    doc: str


def _float64(a: torch.Tensor | np.ndarray) -> torch.Tensor:
    """``a`` as float64 on the device it lies on (a host array on the
    CPU; a sharded one gathered on its first slot): a result volume is
    scored on the device, never copied out."""
    if isinstance(a, ShardedTensor):
        a = a.to(a.devices[0])
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(torch.float64)


def _sharpness(a) -> float:
    """Mean gradient magnitude — sharp, well-tuned reconstructions have
    strong edges."""
    a = _float64(a)
    g = torch.zeros_like(a)
    for ax in range(a.ndim):
        if a.shape[ax] > 1:
            g.narrow(ax, 0, a.shape[ax] - 1).add_(
                torch.diff(a, dim=ax) ** 2)
    return float(torch.mean(torch.sqrt(g)))


def _entropy(a, bins: int = 256) -> float:
    """Shannon entropy of the intensity histogram — a well-tuned
    reconstruction concentrates intensity (lower entropy).  The bins are
    ``np.histogram``'s, counted on the volume's device."""
    a = _float64(a).reshape(-1)
    lo, hi = float(a.min()), float(a.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.from_numpy(np.linspace(lo, hi, bins + 1)).to(a.device)
    idx = ((a - lo) / (hi - lo) * bins).to(torch.int64).clamp_(max=bins - 1)
    # numpy's corrections within an ulp of an edge; the last bin holds
    # its right edge
    idx -= (a < edges[idx]).to(torch.int64)
    idx += ((a >= edges[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    hist = torch.bincount(idx, minlength=bins).cpu().numpy()
    p = hist / max(1, hist.sum())
    p = p[p > 0]
    return float(-np.sum(p * np.log2(p)))


def _std(a) -> float:
    """Standard deviation — contrast proxy."""
    a = _float64(a)
    return float(torch.sqrt(torch.mean((a - torch.mean(a)) ** 2)))


METRICS: dict[str, Metric] = {
    "sharpness": Metric(_sharpness, True, "mean gradient magnitude "
                        "(higher = sharper edges)"),
    "entropy": Metric(_entropy, False, "histogram entropy "
                      "(lower = more concentrated intensity)"),
    "std": Metric(_std, True, "standard deviation (higher = more "
                  "contrast)"),
}


# ----------------------------------------------------------------------
# sweep block parsing + expansion
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepAxis:
    """One grid axis: sweep ``param`` of the ``plugin_index``-th process
    list entry over ``values``."""

    plugin_index: int
    param: str
    values: tuple
    label: str          # "<wire name>.<param>" for snapshots/CLI

    def spec(self) -> dict[str, Any]:
        return {"plugin_index": self.plugin_index, "param": self.param,
                "values": list(self.values), "label": self.label}


def parse_sweep_block(block: Any, process_list: ProcessList
                      ) -> list[SweepAxis]:
    """Validate a ``sweep`` block against the process list.

    Args:
        block: one axis object or a list of ≤ :data:`MAX_AXES` of them;
            each needs ``param``, ``values``, and ``plugin_index`` (or a
            unique ``plugin`` wire name).
        process_list: the chain the axes index into.

    Returns: the validated axes.
    Raises:
        SweepError: malformed block, unresolvable plugin, unknown or
            non-sweepable param (the message names the sweepable ones),
            bad values.
    """
    if isinstance(block, dict):
        block = [block]
    if not isinstance(block, list) or not block:
        raise SweepError('"sweep" must be an axis object or a non-empty '
                         'list of them')
    if len(block) > MAX_AXES:
        raise SweepError(f"at most {MAX_AXES} sweep axes are supported, "
                         f"got {len(block)}")
    axes: list[SweepAxis] = []
    for i, ax in enumerate(block):
        where = f"sweep[{i}]"
        if not isinstance(ax, dict):
            raise SweepError(f"{where}: each axis must be an object, "
                             f"got {ax!r}")
        entry, idx = _resolve_entry(ax, process_list, where)
        param = ax.get("param")
        if not isinstance(param, str):
            raise SweepError(f'{where}: needs a string "param"')
        spec = entry.cls.param_spec()["params"]
        if param not in spec:
            raise SweepError(
                f"{where}: plugin {entry.cls.name!r} has no parameter "
                f"{param!r} (declared: {sorted(spec)})")
        if not spec[param].get("sweepable"):
            sweepable = sorted(k for k, v in spec.items()
                               if v.get("sweepable"))
            raise SweepError(
                f"{where}: parameter {param!r} of {entry.cls.name!r} is "
                f"not sweepable — it selects a different compiled "
                f"program (sweepable: {sweepable or 'none'})")
        values = ax.get("values")
        if not isinstance(values, (list, tuple)) or not values:
            raise SweepError(f'{where}: "values" must be a non-empty '
                             f"list")
        bad = [v for v in values if not _is_jsonable(v)]
        if bad:
            raise SweepError(f"{where}: non-JSON value(s) {bad!r}")
        axes.append(SweepAxis(idx, param, tuple(values),
                              f"{entry.cls.name}.{param}"))
    seen = {(a.plugin_index, a.param) for a in axes}
    if len(seen) != len(axes):
        raise SweepError("sweep axes must name distinct (plugin, param) "
                         "pairs")
    return axes


def _resolve_entry(ax: dict, process_list: ProcessList, where: str
                   ) -> tuple[PluginEntry, int]:
    entries = process_list.entries
    idx = ax.get("plugin_index")
    if idx is not None:
        if not isinstance(idx, int) or isinstance(idx, bool) \
                or not 0 <= idx < len(entries):
            raise SweepError(
                f"{where}: plugin_index must be an int in "
                f"0..{len(entries) - 1}, got {idx!r}")
        return entries[idx], idx
    name = ax.get("plugin")
    if not isinstance(name, str):
        raise SweepError(f'{where}: needs "plugin_index" (int) or a '
                         f'"plugin" wire name')
    matches = [i for i, e in enumerate(entries) if e.cls.name == name]
    if len(matches) != 1:
        raise SweepError(
            f"{where}: plugin {name!r} matches {len(matches)} entries "
            f"(chain: {[e.cls.name for e in entries]}) — use "
            f'"plugin_index"')
    return entries[matches[0]], matches[0]


def expand_sweep(process_list: ProcessList, axes: Iterable[SweepAxis]
                 ) -> list[tuple[tuple, ProcessList]]:
    """Expand the grid: one (values, variant process list) per point, in
    C order (first axis outermost) — the order of the stacked result's
    leading dimension(s).  Every variant is a fresh ProcessList with
    copied params; chain signatures are identical by the tunable-param
    contract."""
    axes = list(axes)
    out: list[tuple[tuple, ProcessList]] = []
    for combo in itertools.product(*[a.values for a in axes]):
        pl = ProcessList()
        for i, e in enumerate(process_list.entries):
            params = dict(e.params)
            for a, v in zip(axes, combo):
                if a.plugin_index == i:
                    params[a.param] = v
            pl.add(e.cls, params=params, in_datasets=e.in_datasets,
                   out_datasets=e.out_datasets)
        out.append((combo, pl))
    return out


# ----------------------------------------------------------------------
# sweep groups
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SweepGroup:
    """One submitted sweep: the expanded variant jobs plus group-level
    bookkeeping (grid shape, per-variant values, metric scores)."""

    sweep_id: str
    axes: list[SweepAxis]
    jobs: list[Job]
    values: list[tuple]                 # grid point per variant
    metric: str | None = None
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)
    scores: list[float] | None = None   # filled lazily once all DONE
    score_error: str | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(a.values) for a in self.axes)

    @property
    def n_variants(self) -> int:
        return len(self.jobs)

    def all_terminal(self) -> bool:
        return all(j.state.terminal() for j in self.jobs)

    def state(self) -> str:
        """Aggregate state: ``queued`` (nothing started) / ``running`` /
        all-terminal ``done`` | ``cancelled`` | ``failed`` (any variant
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

    def best_variant(self) -> dict[str, Any] | None:
        if self.scores is None or not self.scores:
            return None
        m = METRICS[self.metric]
        pick = max if m.higher_is_better else min
        k = self.scores.index(pick(self.scores))
        return {"index": k, "job_id": self.jobs[k].job_id,
                "grid": [int(x) for x in np.unravel_index(k, self.shape)],
                "values": self.values_of(k), "score": self.scores[k]}

    def values_of(self, k: int) -> dict[str, Any]:
        return {a.label: v for a, v in zip(self.axes, self.values[k])}

    def snapshot(self, full: bool = True) -> dict[str, Any]:
        """JSON-able group view (``GET /sweeps/{id}``): aggregate state,
        grid shape + axes, per-variant snapshots with their grid values
        (and scores once computed), ``best_variant`` when a metric was
        requested and every variant is done."""
        counts: dict[str, int] = {}
        for j in self.jobs:
            counts[j.state.value] = counts.get(j.state.value, 0) + 1
        out: dict[str, Any] = {
            "sweep_id": self.sweep_id, "state": self.state(),
            "all_terminal": self.all_terminal(),
            "n_variants": self.n_variants, "shape": list(self.shape),
            "axes": [a.spec() for a in self.axes],
            "metric": self.metric, "created_at": self.created_at,
            "counts": counts,
            "metadata": {k: v for k, v in self.metadata.items()
                         if _is_jsonable(v)},
        }
        if self.score_error:
            out["score_error"] = self.score_error
        best = self.best_variant()
        if best is not None:
            out["best_variant"] = best
        if full:
            variants = []
            for k, j in enumerate(self.jobs):
                v = j.snapshot()
                v["sweep_values"] = self.values_of(k)
                if self.scores is not None:
                    v["score"] = self.scores[k]
                variants.append(v)
            out["variants"] = variants
        return out


# ----------------------------------------------------------------------
class SweepManager:
    """Expands sweep envelopes into atomically-admitted variant jobs and
    tracks them as :class:`SweepGroup`\\ s — the service-side owner of
    the ``/sweeps`` endpoints.

    Args:
        queue: the admission queue variants are submitted to.
        fetch: ``(job_id, dataset|None) -> tensor or array`` resolver
            for a DONE variant's result, where its job left it (the
            service provides one) — used for metric scoring and result
            stacking.
        device: where variants compute, set on their loaders
            (:func:`~.wire.from_spec`); None keeps the spec's.
        max_variants: bound on grid size (400 past it) — admission
            control (``max_pending``) applies on top.
        max_history: retained terminal groups; beyond it the oldest
            all-terminal groups are dropped (their variant jobs remain
            subject to the queue's own ``max_history``).
    """

    def __init__(self, queue: JobQueue, *,
                 fetch: Callable[[str, str | None],
                                 torch.Tensor | np.ndarray] | None = None,
                 max_variants: int = 64,
                 max_history: int | None = 64,
                 device: str | torch.device | None = None):
        self.queue = queue
        self.device = device
        self.fetch = fetch
        self.max_variants = max_variants
        self.max_history = max_history
        self._groups: dict[str, SweepGroup] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.sweeps_submitted = 0
        self.variants_submitted = 0

    # -- admission ------------------------------------------------------
    def submit(self, envelope: dict[str, Any]) -> SweepGroup:
        """Admit one sweep envelope::

            {"process_list": <spec v1 | ProcessList>,   # required
             "sweep": <axis | [axes]>,                  # required
             "metric": null, "priority": 0,
             "sweep_id": null, "metadata": {}}

        Expands the grid and submits every variant **atomically**
        (:meth:`JobQueue.submit_many`) — either the whole sweep is
        admitted (and can gang) or nothing is.

        Returns: the recorded :class:`SweepGroup`.
        Raises:
            SweepError / WireError / ProcessListError: invalid envelope
                or spec (HTTP 400).
            ValueError: duplicate active sweep/job id (HTTP 409).
            QueueFull: admission control rejected the whole group
                (HTTP 429).
        """
        if not isinstance(envelope, dict) or "process_list" not in envelope:
            raise SweepError('body must be an object with a '
                             '"process_list" spec')
        if "sweep" not in envelope:
            raise SweepError('body must carry a "sweep" block (use '
                             'POST /jobs for plain submissions)')
        priority = envelope.get("priority", 0)
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise SweepError(f"priority must be an integer, got "
                             f"{priority!r}")
        metric = envelope.get("metric")
        if metric is not None and metric not in METRICS:
            raise SweepError(f"unknown metric {metric!r} "
                             f"(available: {sorted(METRICS)})")
        sweep_id = envelope.get("sweep_id")
        if sweep_id is not None and not isinstance(sweep_id, str):
            raise SweepError(f"sweep_id must be a string, got "
                             f"{sweep_id!r}")
        metadata = envelope.get("metadata") or {}
        if not isinstance(metadata, dict):
            raise SweepError("metadata must be an object")

        pl = envelope["process_list"]
        if not isinstance(pl, ProcessList):
            pl = from_spec(pl, device=self.device)
        pl.check()
        axes = parse_sweep_block(envelope["sweep"], pl)
        n = 1
        for a in axes:
            n *= len(a.values)
        if n > self.max_variants:
            raise SweepError(
                f"sweep expands to {n} variants "
                f"(max_variants={self.max_variants}) — coarsen the grid")
        variants = expand_sweep(pl, axes)

        with self._lock:
            self._prune_locked()
            if sweep_id is None:
                sweep_id = f"sweep-{next(self._seq):04d}"
            existing = self._groups.get(sweep_id)
            if existing is not None and not existing.all_terminal():
                raise ValueError(f"sweep id {sweep_id!r} already active")
        job_ids = [f"{sweep_id}/v{k:03d}" for k in range(len(variants))]
        metadatas = []
        for k, (combo, _) in enumerate(variants):
            md = dict(metadata)
            md["sweep"] = {
                "sweep_id": sweep_id, "index": k,
                "values": {a.label: v for a, v in zip(axes, combo)}}
            metadatas.append(md)
        jobs = self.queue.submit_many(
            [v for _, v in variants], priority=priority,
            job_ids=job_ids, metadatas=metadatas)
        group = SweepGroup(sweep_id, axes, jobs,
                           [combo for combo, _ in variants],
                           metric=metric, metadata=dict(metadata))
        with self._lock:
            self._groups[sweep_id] = group
            self.sweeps_submitted += 1
            self.variants_submitted += len(jobs)
        return group

    def _prune_locked(self) -> None:
        if self.max_history is None:
            return
        terminal = [g for g in self._groups.values() if g.all_terminal()]
        terminal.sort(key=lambda g: g.created_at)
        for g in terminal[:max(0, len(terminal) - self.max_history)]:
            del self._groups[g.sweep_id]

    # -- lookup ----------------------------------------------------------
    def group(self, sweep_id: str) -> SweepGroup:
        """Raises KeyError for an unknown (or pruned) sweep id."""
        with self._lock:
            return self._groups[sweep_id]

    def status(self, sweep_id: str, full: bool = True) -> dict[str, Any]:
        """The group snapshot, scoring variants first when a metric was
        requested and every variant is DONE (lazy, computed once)."""
        g = self.group(sweep_id)
        self._ensure_scores(g)
        return g.snapshot(full=full)

    def snapshot_all(self) -> list[dict[str, Any]]:
        """Summary snapshot of every retained group (``GET /sweeps``)."""
        with self._lock:
            groups = sorted(self._groups.values(),
                            key=lambda g: g.created_at)
        return [g.snapshot(full=False) for g in groups]

    # -- metric scoring ---------------------------------------------------
    def _ensure_scores(self, g: SweepGroup) -> None:
        if g.metric is None or g.scores is not None or self.fetch is None:
            return
        if g.state() != "done":
            return
        m = METRICS[g.metric]
        try:
            scores = [float(m.fn(self.fetch(j.job_id, None)))
                      for j in g.jobs]
        except (KeyError, RuntimeError, OSError) as e:
            # results evicted/unreadable: report, don't fail the status
            g.score_error = f"{type(e).__name__}: {e}"
            return
        g.scores = scores

    # -- cancellation -----------------------------------------------------
    def cancel(self, sweep_id: str,
               cancel_job: Callable[[str], dict[str, Any]]
               ) -> dict[str, Any]:
        """Cancel every live variant via ``cancel_job`` (the service's
        per-job cancel, which handles queued AND leased jobs).  Variants
        already terminal are left alone.  Raises KeyError if unknown."""
        g = self.group(sweep_id)
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
        return {"sweep_id": sweep_id, "state": g.state(),
                "cancelled": cancelled, "skipped": skipped}

    # -- results ----------------------------------------------------------
    def result_plan(self, sweep_id: str, dataset: str | None = None
                    ) -> tuple[SweepGroup, tuple[int, ...], np.dtype,
                               torch.Tensor | np.ndarray]:
        """Resolve what ``GET /sweeps/{id}/result`` will stream: the
        group, the STACKED shape (``(*grid_shape, *variant_shape)`` —
        the parameter axes lead, Savu's tuning dimension), the dtype,
        and the first variant's result where its job left it (so the
        caller streams it without fetching twice; the others one at a
        time after it).

        Raises:
            KeyError: unknown sweep.
            RuntimeError: not every variant is DONE (the message names
                the blocking states), or variant results disagree on
                shape/dtype (should not happen for identical chains).
        """
        g = self.group(sweep_id)
        if g.state() != "done":
            counts = {j.job_id: j.state.value for j in g.jobs
                      if j.state.value != "done"}
            raise RuntimeError(
                f"sweep {sweep_id!r} is {g.state()!r}, not done "
                f"(blocking: {counts})")
        if self.fetch is None:
            raise RuntimeError("no result fetcher configured")
        first = self.fetch(g.jobs[0].job_id, dataset)
        dtype = (torch.empty(0, dtype=first.dtype).numpy().dtype
                 if isinstance(first.dtype, torch.dtype) else first.dtype)
        return (g, g.shape + tuple(first.shape), dtype, first)

    def stats(self) -> dict[str, Any]:
        """Counters for ``GET /stats``: groups retained/active plus
        lifetime ``sweeps_submitted`` / ``variants_submitted``."""
        with self._lock:
            groups = list(self._groups.values())
            out = {"sweeps_submitted": self.sweeps_submitted,
                   "variants_submitted": self.variants_submitted,
                   "groups": len(groups),
                   "active": sum(1 for g in groups
                                 if not g.all_terminal())}
        return out
