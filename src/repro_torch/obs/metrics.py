"""Metrics registry — counters, gauges and bounded-reservoir histograms
behind one namespace, replacing the hand-rolled per-component ``stats()``
dicts.  The port's copy of ``repro.obs.metrics`` (stdlib only, copied
rather than imported); the catalogue names the front end's metrics too,
which arrive with the front-end slice.

The facility papers this repo tracks (Savu's profiler, Nanosurveyor's
live status stream, CHESS's facility-wide dashboards) all treat
monitoring as infrastructure, not printf.  Design points:

* **One registry per service** (no process-global state — tests can run
  many services in one process).  Components take the registry as an
  optional constructor argument and no-op cleanly without it.
* **Counters** only go up.  **Gauges** hold a value or call a function
  at read time (``queue.depth`` reads the live queue, nothing pushes).
* **Histograms** keep a bounded reservoir (Vitter's algorithm R with a
  seeded RNG — deterministic under test) so p50/p95/p99 stay O(1) RAM
  no matter how many jobs flow through; ``count``/``sum`` stay exact.
* **Prometheus text exposition** (``GET /metrics``): dots become
  underscores, histograms render as summaries with ``quantile`` labels.
* A **catalogue** of well-known names is pre-registered by the service
  so ``/metrics`` is complete from the first scrape (and CI can fail on
  a missing name rather than on a race with traffic).
"""
from __future__ import annotations

import random
import re
import threading
from typing import Any, Callable, Iterable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: quantiles every histogram reports
QUANTILES = (0.5, 0.95, 0.99)


def prometheus_name(name: str) -> str:
    """Sanitise a dotted metric name for the Prometheus exposition
    format (``job.latency.e2e`` -> ``job_latency_e2e``)."""
    name = _NAME_RE.sub("_", name.replace(".", "_"))
    if name and name[0].isdigit():
        name = "_" + name
    return name


class Counter:
    """Monotonic counter (``jobs.completed``, ``lease.expired``...)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) — counters "
                             f"only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: either set explicitly or computed by a
    zero-arg callback at read time (``queue.depth`` must reflect the
    queue NOW, not the last event)."""

    def __init__(self, name: str, help: str = "",
                 fn: Callable[[], float] | None = None):
        self.name, self.help = name, help
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:        # noqa: BLE001 — scrape must not 500
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir histogram with exact count/sum and
    reservoir-estimated quantiles.

    Reservoir sampling (algorithm R) keeps a uniform sample of all
    observations in ``reservoir_size`` slots; with the default 1024
    slots the p99 estimate is stable to a few percent while RAM stays
    constant over a service's lifetime.  The RNG is seeded per-instance
    so test runs are reproducible.
    """

    def __init__(self, name: str, help: str = "",
                 reservoir_size: int = 1024, seed: int = 0):
        if reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1")
        self.name, self.help = name, help
        self.reservoir_size = reservoir_size
        self._rng = random.Random(seed)
        self._reservoir: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._reservoir) < self.reservoir_size:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.reservoir_size:
                    self._reservoir[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float | None:
        """The q-quantile (0 <= q <= 1) of the reservoir sample — None
        while empty.  Nearest-rank on the sorted sample: q=0 is the
        min, q=1 the max, and every returned value is an actual
        observation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if not self._reservoir:
                return None
            data = sorted(self._reservoir)
        idx = min(len(data) - 1, int(q * len(data)))
        return data[idx]

    def quantiles(self, qs: Iterable[float] = QUANTILES
                  ) -> dict[float, float | None]:
        return {q: self.quantile(q) for q in qs}


class MetricsRegistry:
    """Name -> instrument registry for one service.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent,
    so components can declare what they use without coordinating);
    re-registering a name as a different kind raises.  ``snapshot()``
    is the JSON view (folded into ``GET /stats``),
    ``render_prometheus()`` the text exposition for ``GET /metrics``.
    """

    #: content type of the Prometheus text exposition format
    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: type, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, **kw)
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Callable[[], float] | None = None) -> Gauge:
        g = self._get_or_create(name, Gauge, help=help)
        if fn is not None:
            g.set_function(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  reservoir_size: int = 1024) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   reservoir_size=reservoir_size)

    def get(self, name: str) -> Any | None:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """JSON-able view: counters/gauges as numbers, histograms as
        ``{count, sum, p50, p95, p99}``."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, Any] = {}
        for name, m in sorted(items):
            if isinstance(m, Histogram):
                qs = m.quantiles()
                out[name] = {"count": m.count, "sum": round(m.sum, 6),
                             **{f"p{int(q * 100)}": qs[q]
                                for q in QUANTILES}}
            else:
                out[name] = m.value
        return out

    def render_prometheus(self) -> str:
        """The text exposition format, one block per metric: ``# HELP``
        / ``# TYPE`` then the samples; histograms as summaries with
        ``quantile`` labels plus ``_count``/``_sum``."""
        with self._lock:
            items = list(self._metrics.items())
        lines: list[str] = []
        for name, m in sorted(items):
            pname = prometheus_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q, v in m.quantiles().items():
                    if v is not None:
                        lines.append(
                            f'{pname}{{quantile="{q}"}} {_fmt(v)}')
                lines.append(f"{pname}_count {m.count}")
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v != v:                       # NaN
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# -- the service's well-known metric names ------------------------------
#: (dotted name, kind, help) — pre-registered by the service so the
#: ``/metrics`` exposition is complete from the first scrape.  CI fails
#: if any of these is missing from a live endpoint.
CATALOGUE: tuple[tuple[str, str, str], ...] = (
    ("queue.depth", "gauge", "jobs waiting in the admission queue"),
    ("queue.oldest_age_s", "gauge",
     "age in seconds of the oldest still-queued job (starvation signal)"),
    ("jobs.submitted", "counter", "jobs admitted via submit"),
    ("jobs.completed", "counter", "jobs that reached done"),
    ("jobs.failed", "counter", "jobs that reached failed"),
    ("jobs.cancelled", "counter", "jobs cancelled before completion"),
    ("jobs.requeued", "counter",
     "jobs requeued after a lease expiry (broker mode)"),
    ("lease.expired", "counter", "leases expired by the broker sweep"),
    ("leases.active", "gauge", "leases currently held by workers"),
    ("workers.registered", "gauge", "worker processes registered"),
    ("compile.cache.hits", "gauge", "compile-cache hits (process cache)"),
    ("compile.cache.misses", "gauge",
     "compile-cache misses (process cache)"),
    ("compile.cache.disk.hits", "gauge",
     "compile-cache disk-tier hits (deserialized executables)"),
    ("compile.cache.disk.misses", "gauge",
     "compile-cache disk-tier misses (fresh compiles)"),
    ("executables.uploaded", "counter",
     "serialized executables accepted over PUT /executables/{sig}"),
    ("executables.served", "counter",
     "serialized executables streamed over GET /executables/{sig}"),
    ("executables.spool.bytes", "gauge",
     "bytes currently held in the broker's executable spool"),
    ("job.latency.e2e", "histogram",
     "submit-to-terminal latency, seconds"),
    ("job.latency.queue", "histogram",
     "submit-to-dispatch queue wait, seconds"),
    ("plugin.wall", "histogram",
     "per-plugin-step wall time across all jobs, seconds"),
    ("gang.fallback", "counter",
     "gang steps run member by member after a batch-signature mismatch"),
    # -- streaming acquisition (docs/streaming.md) ----------------------
    ("stream.frames.ingested", "counter",
     "frames accepted over POST /jobs/{id}/frames"),
    ("jobs.parked", "counter",
     "streaming-job leases ended early for frame starvation (parked)"),
    ("stream.ingest_lag_s", "histogram",
     "frame arrival to executor consumption lag, seconds"),
    ("stream.window_latency_s", "histogram",
     "wall time of one arrival-driven pump over new frames, seconds"),
    # -- health plane (docs/observability.md: events + SLO) -------------
    ("executables.rejected", "counter",
     "executable uploads the broker spool refused (unframed/corrupt)"),
    ("alerts.fired", "counter",
     "SLO alert pending->firing transitions"),
    ("alerts.resolved", "counter",
     "SLO alert firing->resolved transitions"),
    ("slo.firing", "gauge", "SLO rules currently in the firing state"),
    ("events.head", "gauge",
     "newest structured-event sequence number (event-log write head)"),
)


def register_catalogue(reg: MetricsRegistry) -> None:
    """Pre-register every well-known metric (idempotent)."""
    for name, kind, help_ in CATALOGUE:
        getattr(reg, kind)(name, help=help_)


def catalogue_names() -> list[str]:
    return [name for name, _, _ in CATALOGUE]
