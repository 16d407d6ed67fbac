from .log import EventLog
from .metrics import (CATALOGUE, QUANTILES, Counter, Gauge, Histogram,
                      MetricsRegistry, catalogue_names, prometheus_name,
                      register_catalogue)
from .trace import (Span, Trace, current_trace, new_span_id, new_trace_id,
                    use_trace)

__all__ = [
    "Span", "Trace", "current_trace", "use_trace", "new_trace_id",
    "new_span_id", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "register_catalogue", "catalogue_names", "prometheus_name",
    "CATALOGUE", "QUANTILES", "EventLog",
]
