"""OTLP-shaped JSON export bridge — stdlib only.  The port's copy of
``repro.obs.export`` (copied rather than imported); its scope and
service names are the reference's, so a collector sees one service.

The native trace/metrics wire formats (``Trace.to_wire()``,
``MetricsRegistry.snapshot()``) are this repo's own; real facilities
feed Jaeger/Tempo/Prometheus-compatible backends.  This module maps
both onto the OpenTelemetry OTLP/JSON shapes (`resourceSpans` /
`resourceMetrics`) WITHOUT taking an opentelemetry dependency: the
output is plain dicts that ``json.dumps`` straight into an OTLP/HTTP
collector body or a file an offline ingester replays.

Span mapping is 1:1 and lossless for our model: ids are zero-padded to
OTLP's 32-hex trace / 16-hex span ids (ours are 16-hex uuid4 prefixes),
timestamps become unix nanos, and ``attrs`` become OTLP keyValue lists.
Spans are grouped into one ``resourceSpans`` entry per recording
process (``worker_id``), so resource attributes carry worker/broker
identity the way OTLP intends.

:class:`OtlpSpool` writes export documents into a directory (atomic
tmp+rename, bounded like :class:`~.trace.TraceSpool`) for
offline ingestion — the CI artifact path.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterable

#: instrumentation scope stamped on every export
SCOPE = {"name": "repro.obs", "version": "1"}


def _otlp_id(hex_id: str, width: int) -> str:
    """Zero-pad (or truncate) a hex id to OTLP's fixed width: 32 chars
    for trace ids, 16 for span ids.  Non-hex ids (user-supplied
    trace_ids) are hashed into range instead of rejected — export must
    never fail on telemetry."""
    s = (hex_id or "").lower()
    try:
        int(s, 16)
    except ValueError:
        s = f"{hash(s) & (16 ** width - 1):x}"
    return s[:width].rjust(width, "0")


def _nanos(t: float | None) -> str:
    """Unix nanos as a string (OTLP/JSON encodes uint64 as strings)."""
    return str(int((t or 0.0) * 1e9))


def _any_value(v: Any) -> dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_any_value(x) for x in v]}}
    return {"stringValue": str(v)}


def _attributes(attrs: dict[str, Any]) -> list[dict[str, Any]]:
    return [{"key": str(k), "value": _any_value(v)}
            for k, v in attrs.items()]


def _resource(identity: str, extra: dict[str, Any] | None = None
              ) -> dict[str, Any]:
    """OTLP resource for one recording process: ``service.name`` is the
    pipeline service, ``service.instance.id`` the worker/broker id."""
    return {"attributes": _attributes({
        "service.name": "repro.pipeline",
        "service.instance.id": identity,
        **(extra or {})})}


def _wire_spans(trace: Any) -> tuple[str, list[dict[str, Any]]]:
    """Normalise a :class:`~.trace.Trace` OR its wire document
    (``{"trace_id", "spans": [...]}``) to ``(trace_id, wire spans)``."""
    if isinstance(trace, dict):
        return str(trace.get("trace_id") or ""), \
            list(trace.get("spans") or ())
    return trace.trace_id, [s.to_wire() for s in trace.spans()]


def trace_to_otlp(trace: Any,
                  resource_attrs: dict[str, Any] | None = None
                  ) -> dict[str, Any]:
    """One job's trace as an OTLP/JSON ``ExportTraceServiceRequest``.

    Args:
        trace: a live :class:`~.trace.Trace` or the wire dict
            ``GET /jobs/{id}/trace`` serves.
        resource_attrs: extra resource attributes stamped on every
            ``resourceSpans`` entry (e.g. ``{"job.id": ...}``).

    Spans map 1:1 — every native span becomes exactly one OTLP span
    (same count, padded ids) — grouped by recording ``worker_id`` into
    per-process ``resourceSpans`` entries ("broker" for spans recorded
    service-side).
    """
    trace_id, spans = _wire_spans(trace)
    tid = _otlp_id(trace_id, 32)
    by_proc: dict[str, list[dict[str, Any]]] = {}
    for d in spans:
        end = d.get("end")
        span = {
            "traceId": tid,
            "spanId": _otlp_id(str(d.get("span_id") or ""), 16),
            "name": str(d.get("name") or ""),
            "kind": 1,                       # SPAN_KIND_INTERNAL
            "startTimeUnixNano": _nanos(d.get("start")),
            # an open span exports end == start: OTLP has no "open"
            "endTimeUnixNano": _nanos(end if end is not None
                                      else d.get("start")),
        }
        if d.get("parent_id"):
            span["parentSpanId"] = _otlp_id(str(d["parent_id"]), 16)
        if d.get("attrs"):
            span["attributes"] = _attributes(d["attrs"])
        by_proc.setdefault(str(d.get("worker_id") or "broker"),
                           []).append(span)
    return {"resourceSpans": [
        {"resource": _resource(proc, resource_attrs),
         "scopeSpans": [{"scope": SCOPE, "spans": procspans}]}
        for proc, procspans in sorted(by_proc.items())]}


def metrics_to_otlp(snapshot: dict[str, Any], identity: str = "broker",
                    now: float | None = None) -> dict[str, Any]:
    """A registry snapshot (``MetricsRegistry.snapshot()``) as an
    OTLP/JSON ``ExportMetricsServiceRequest``: counters become
    monotonic cumulative sums, gauges become gauges, histogram
    summaries become OTLP summaries with quantile values."""
    ts = _nanos(now if now is not None else time.time())
    metrics: list[dict[str, Any]] = []
    for name, value in sorted(snapshot.items()):
        if isinstance(value, dict):          # histogram summary view
            qvals = [{"quantile": q / 100.0,
                      "value": float(value[f"p{q}"])}
                     for q in (50, 95, 99)
                     if value.get(f"p{q}") is not None]
            metrics.append({"name": name, "summary": {"dataPoints": [
                {"timeUnixNano": ts,
                 "count": str(int(value.get("count", 0))),
                 "sum": float(value.get("sum", 0.0)),
                 "quantileValues": qvals}]}})
        elif isinstance(value, bool) or not isinstance(value,
                                                       (int, float)):
            continue                         # not a metric sample
        elif isinstance(value, int):         # counters are ints
            metrics.append({"name": name, "sum": {
                "aggregationTemporality": 2,     # CUMULATIVE
                "isMonotonic": True,
                "dataPoints": [{"timeUnixNano": ts,
                                "asDouble": float(value)}]}})
        else:                                # gauges are floats
            if value != value:               # NaN scrape: skip sample
                metrics.append({"name": name,
                                "gauge": {"dataPoints": []}})
                continue
            metrics.append({"name": name, "gauge": {
                "dataPoints": [{"timeUnixNano": ts,
                                "asDouble": float(value)}]}})
    return {"resourceMetrics": [
        {"resource": _resource(identity),
         "scopeMetrics": [{"scope": SCOPE, "metrics": metrics}]}]}


class OtlpSpool:
    """Bounded directory of OTLP/JSON export documents for offline
    ingestion (``cat *.otlp.json | curl collector`` or the CI artifact
    upload).  Files are written atomically; past ``max_files`` the
    oldest (mtime) are deleted."""

    def __init__(self, root: str, max_files: int = 256):
        if max_files < 1:
            raise ValueError(f"max_files must be >= 1, got {max_files}")
        self.root = root
        self.max_files = max_files
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def put(self, name: str, doc: dict[str, Any]) -> str:
        """Write one export document as ``<name>.otlp.json`` (name is
        sanitised); returns the path."""
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name) or "export"
        path = os.path.join(self.root, f"{safe}.otlp.json")
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, path)
            self._evict_locked()
        return path

    def export_trace(self, job_id: str, trace: Any, **resource_attrs
                     ) -> str:
        return self.put(f"trace-{job_id}",
                        trace_to_otlp(trace, {"job.id": job_id,
                                              **resource_attrs}))

    def export_metrics(self, snapshot: dict[str, Any],
                       identity: str = "broker") -> str:
        return self.put("metrics",
                        metrics_to_otlp(snapshot, identity=identity))

    def _evict_locked(self) -> None:
        try:
            files = [os.path.join(self.root, f)
                     for f in os.listdir(self.root)
                     if f.endswith(".otlp.json")]
        except OSError:
            return
        if len(files) <= self.max_files:
            return
        files.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in files[:len(files) - self.max_files]:
            try:
                os.remove(p)
            except OSError:
                pass

    def __len__(self) -> int:
        try:
            return sum(1 for f in os.listdir(self.root)
                       if f.endswith(".otlp.json"))
        except OSError:
            return 0


def iter_spans(otlp_doc: dict[str, Any]) -> Iterable[dict[str, Any]]:
    """Flatten an OTLP trace document back to its span dicts — the
    1:1 check in tests/bench walks this."""
    for rs in otlp_doc.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            yield from ss.get("spans", ())
