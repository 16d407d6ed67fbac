# Telemetry layer: job tracing, metrics registry, structured event log,
# SLO alerting and OTLP export -- the port's copies of ``repro.obs``
# (stdlib only).  Core and service both import obs, never the other way
# round.
from .export import (OtlpSpool, iter_spans, metrics_to_otlp,
                     trace_to_otlp)
from .log import EventLog
from .metrics import (CATALOGUE, QUANTILES, Counter, Gauge, Histogram,
                      MetricsRegistry, catalogue_names, prometheus_name,
                      register_catalogue)
from .slo import SloEngine, SloRule, default_rules, rules_from_spec
from .trace import (Span, Trace, TraceSpool, current_trace, new_span_id,
                    new_trace_id, render_gantt, use_trace)

__all__ = [
    "Span", "Trace", "TraceSpool", "current_trace", "use_trace",
    "new_trace_id", "new_span_id", "render_gantt", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "register_catalogue", "catalogue_names",
    "prometheus_name", "CATALOGUE", "QUANTILES", "EventLog", "SloEngine",
    "SloRule", "default_rules", "rules_from_spec", "OtlpSpool",
    "trace_to_otlp", "metrics_to_otlp", "iter_spans",
]
