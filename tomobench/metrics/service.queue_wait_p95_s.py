"""service.queue_wait_p95_s: the 95th percentile of the ``queue.wait``
spans (submission to dispatch) of every job of the window's requests."""
from tomobench.record import quantile


def read(rec):
    return quantile((s.wall for r in rec.requests for s in r.spans
                     if s.name == "queue.wait"), 0.95)
