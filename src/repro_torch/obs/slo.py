"""Declarative SLO rule engine with a full alert lifecycle.  The port's
copy of ``repro.obs.slo`` (stdlib only, copied rather than imported).

The load proof (``benchmarks/bench_load.py``) showed the service can
*report* queue age, latency quantiles and lease expiries; this module
makes the service *judge* them continuously.  A :class:`SloRule` names
one metric in the registry, how to read it (gauge value, histogram
quantile, or increase of a counter over a trailing window), a threshold,
and hold-down windows; the :class:`SloEngine` evaluates every rule
periodically and walks each through the alert lifecycle::

    ok ──breach──▶ pending ──breached ≥ for_s──▶ firing
    firing ──clear ≥ resolve_s──▶ ok   (one ``alert.resolved`` event)

Transitions are exactly-once events into the structured
:class:`~.log.EventLog` (``alert.pending`` / ``alert.firing`` /
``alert.resolved``), stamped with the engine's own trace id so every
event record joins the common schema.  ``critical=True`` rules feed the
degrade-aware readiness probe: ``GET /healthz?ready=1`` answers 503
while any critical rule is firing.

Defaults cover the signals the ROADMAP calls out — queue oldest-age,
``job.latency.e2e`` p99, lease-expiry rate, streaming ingest lag, and
executable-store rejects — and a ``spec`` dict overrides or extends
them per deployment (see :func:`rules_from_spec`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

from .log import EventLog
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import new_trace_id

#: alert lifecycle states
OK, PENDING, FIRING = "ok", "pending", "firing"


@dataclasses.dataclass
class SloRule:
    """One declarative service-level objective.

    ``kind`` selects how ``metric`` is read from the registry:

    * ``"gauge"`` — the gauge's current value.
    * ``"quantile"`` — the histogram's ``quantile(q)`` (no breach while
      the histogram is empty).
    * ``"rate"`` — the counter's INCREASE over the trailing
      ``window_s`` seconds (events per window, not per second): the
      natural reading for "any lease expired recently?".

    The rule breaches while ``value <op> threshold``; it must stay
    breached ``for_s`` seconds to go firing, and stay clear
    ``resolve_s`` seconds to resolve — hold-downs against flapping.
    """

    name: str
    metric: str
    threshold: float
    kind: str = "gauge"              # "gauge" | "quantile" | "rate"
    op: str = ">"                    # ">" | "<"
    quantile: float = 0.99           # for kind="quantile"
    window_s: float = 30.0           # for kind="rate"
    for_s: float = 0.0               # breach hold-down before firing
    resolve_s: float = 0.0           # clear hold-down before resolving
    critical: bool = False           # feeds /healthz?ready=1
    help: str = ""

    def __post_init__(self):
        if self.kind not in ("gauge", "quantile", "rate"):
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"rule {self.name!r}: op must be '>' or "
                             f"'<', got {self.op!r}")

    def breached(self, value: float | None) -> bool:
        if value is None:
            return False
        return value > self.threshold if self.op == ">" \
            else value < self.threshold


def default_rules() -> list[SloRule]:
    """The rule set every service evaluates out of the box.  Thresholds
    are deliberately generous — a facility overrides them per
    deployment via the ``spec`` dict; the engine's job here is to make
    the lifecycle machinery always-on, not to guess one site's SLOs."""
    return [
        SloRule("queue-oldest-age", "queue.oldest_age_s", 120.0,
                kind="gauge", for_s=5.0, resolve_s=5.0,
                help="oldest queued job is starving"),
        SloRule("job-latency-p99", "job.latency.e2e", 300.0,
                kind="quantile", quantile=0.99, for_s=5.0,
                resolve_s=10.0,
                help="end-to-end p99 latency out of budget"),
        SloRule("lease-expiry-rate", "lease.expired", 0.0,
                kind="rate", window_s=30.0, critical=True,
                help="a worker stopped heartbeating (lease expired "
                     "recently)"),
        SloRule("ingest-lag", "stream.ingest_lag_s", 30.0,
                kind="quantile", quantile=0.95, for_s=5.0,
                resolve_s=10.0,
                help="streaming executors fell behind the beamline"),
        SloRule("executable-rejects", "executables.rejected", 0.0,
                kind="rate", window_s=60.0,
                help="workers uploading corrupt/unframed executables"),
    ]


def rules_from_spec(spec: dict[str, Any] | None) -> list[SloRule]:
    """The default rules merged with a user ``spec`` dict.

    ``spec`` maps rule name -> field overrides (any :class:`SloRule`
    field).  Overriding a default rule patches it in place; a new name
    defines a new rule (``"metric"`` and ``"threshold"`` required);
    mapping a name to ``None`` (or ``False``) disables that rule::

        {"lease-expiry-rate": {"window_s": 5.0},   # tighten a default
         "my-depth": {"metric": "queue.depth", "threshold": 50,
                      "critical": True},           # add a rule
         "ingest-lag": None}                       # disable a default

    Raises ValueError on unknown fields or an incomplete new rule.
    """
    rules = {r.name: r for r in default_rules()}
    fields = {f.name for f in dataclasses.fields(SloRule)}
    for name, patch in (spec or {}).items():
        if patch is None or patch is False:
            rules.pop(name, None)
            continue
        if not isinstance(patch, dict):
            raise ValueError(f"slo spec for {name!r} must be a dict "
                             f"(or None to disable), got {patch!r}")
        unknown = set(patch) - fields
        if unknown:
            raise ValueError(f"slo spec for {name!r}: unknown fields "
                             f"{sorted(unknown)}")
        if name in rules:
            rules[name] = dataclasses.replace(rules[name], **patch)
        else:
            if "metric" not in patch or "threshold" not in patch:
                raise ValueError(
                    f"new slo rule {name!r} needs at least 'metric' "
                    f"and 'threshold'")
            rules[name] = SloRule(name=name, **patch)
    return list(rules.values())


class _RuleState:
    """Mutable per-rule lifecycle bookkeeping."""

    __slots__ = ("state", "since", "breach_since", "clear_since",
                 "value", "fired", "resolved", "samples")

    def __init__(self):
        self.state = OK
        self.since: float | None = None       # current state entered at
        self.breach_since: float | None = None
        self.clear_since: float | None = None
        self.value: float | None = None
        self.fired = 0                        # lifetime firing count
        self.resolved = 0
        #: (t, counter value) samples for kind="rate"
        self.samples: deque[tuple[float, float]] = deque()


class SloEngine:
    """Periodic evaluator: rules over a registry, transitions into an
    event log.

    The service owns one engine and drives :meth:`evaluate` from a
    background thread (and opportunistically from ``GET /slo`` /
    ``GET /healthz?ready=1`` so responses are fresh); evaluation is
    serialised under an internal lock, so extra callers never
    double-emit a transition.
    """

    def __init__(self, registry: MetricsRegistry,
                 events: EventLog | None = None,
                 spec: dict[str, Any] | None = None):
        self.registry = registry
        self.events = events
        self.rules = rules_from_spec(spec)
        self.trace_id = new_trace_id()   # the health plane's own trace
        self._states = {r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        self._evaluated_at: float | None = None

    # -- reading metrics ------------------------------------------------
    def _read(self, rule: SloRule, st: _RuleState,
              now: float) -> float | None:
        m = self.registry.get(rule.metric)
        if m is None:
            return None
        if rule.kind == "gauge":
            if not isinstance(m, (Gauge, Counter)):
                return None
            v = float(m.value)
            return None if v != v else v          # NaN -> unknown
        if rule.kind == "quantile":
            if not isinstance(m, Histogram):
                return None
            return m.quantile(rule.quantile)
        # kind == "rate": increase over the trailing window
        if not isinstance(m, Counter):
            return None
        v = float(m.value)
        st.samples.append((now, v))
        horizon = now - rule.window_s
        # keep one sample at-or-before the horizon as the baseline
        while len(st.samples) > 1 and st.samples[1][0] <= horizon:
            st.samples.popleft()
        return v - st.samples[0][1]

    # -- lifecycle ------------------------------------------------------
    def _emit(self, event: str, rule: SloRule, st: _RuleState) -> None:
        if self.events is not None:
            self.events.emit(event, trace_id=self.trace_id,
                             rule=rule.name, metric=rule.metric,
                             value=st.value, threshold=rule.threshold,
                             critical=rule.critical)

    def evaluate(self, now: float | None = None) -> list[str]:
        """One evaluation pass over every rule.  Returns the transition
        events emitted this pass (``["alert.firing", ...]``) — mostly
        for tests; the real outputs are the event log and the states
        :meth:`snapshot` reports."""
        now = time.time() if now is None else now
        emitted: list[str] = []
        with self._lock:
            self._evaluated_at = now
            for rule in self.rules:
                st = self._states[rule.name]
                st.value = self._read(rule, st, now)
                if rule.breached(st.value):
                    st.clear_since = None
                    if st.breach_since is None:
                        st.breach_since = now
                    if st.state == OK:
                        st.state, st.since = PENDING, now
                        self._emit("alert.pending", rule, st)
                        emitted.append("alert.pending")
                    if st.state == PENDING and \
                            now - st.breach_since >= rule.for_s:
                        st.state, st.since = FIRING, now
                        st.fired += 1
                        self._emit("alert.firing", rule, st)
                        emitted.append("alert.firing")
                        self.registry.counter("alerts.fired").inc()
                else:
                    st.breach_since = None
                    if st.state == PENDING:
                        # never fired: fold back silently (no alert
                        # lifecycle event was owed to operators)
                        st.state, st.since = OK, now
                        st.clear_since = None
                    elif st.state == FIRING:
                        if st.clear_since is None:
                            st.clear_since = now
                        if now - st.clear_since >= rule.resolve_s:
                            st.state, st.since = OK, now
                            st.clear_since = None
                            st.resolved += 1
                            self._emit("alert.resolved", rule, st)
                            emitted.append("alert.resolved")
                            self.registry.counter(
                                "alerts.resolved").inc()
        return emitted

    # -- reading --------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """The ``GET /slo`` payload: every rule's definition, current
        reading and lifecycle state, plus the firing summary."""
        with self._lock:
            rules = []
            for rule in self.rules:
                st = self._states[rule.name]
                rules.append({
                    "name": rule.name, "metric": rule.metric,
                    "kind": rule.kind, "op": rule.op,
                    "threshold": rule.threshold,
                    **({"quantile": rule.quantile}
                       if rule.kind == "quantile" else {}),
                    **({"window_s": rule.window_s}
                       if rule.kind == "rate" else {}),
                    "for_s": rule.for_s, "resolve_s": rule.resolve_s,
                    "critical": rule.critical, "help": rule.help,
                    "state": st.state, "value": st.value,
                    "since": st.since, "fired": st.fired,
                    "resolved": st.resolved,
                })
            return {
                "rules": rules,
                "firing": [r["name"] for r in rules
                           if r["state"] == FIRING],
                "critical_firing": [r["name"] for r in rules
                                    if r["state"] == FIRING
                                    and r["critical"]],
                "evaluated_at": self._evaluated_at,
                "trace_id": self.trace_id,
            }

    def critical_firing(self) -> list[dict[str, Any]]:
        """Firing critical rules, as machine-readable detail for the
        503 readiness reply."""
        snap = self.snapshot()
        return [r for r in snap["rules"]
                if r["state"] == FIRING and r["critical"]]

    def n_firing(self) -> int:
        """Count of rules currently firing (the ``slo.firing`` gauge)."""
        with self._lock:
            return sum(1 for st in self._states.values()
                       if st.state == FIRING)
