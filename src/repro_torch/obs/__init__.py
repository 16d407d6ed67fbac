from .trace import Span, Trace, current_trace, use_trace

__all__ = ["Span", "Trace", "current_trace", "use_trace"]
