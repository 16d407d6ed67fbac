"""Arithmetic of the readers of the ``reused`` attribute of the
program's ``transport.to_host`` spans: whether a volume read off the
card found its page-locked host block in the host allocator's cache.
A program whose spans lack the attribute gives every reader None."""
from __future__ import annotations

from .copies import TO_HOST
from .record import Record


def reused_pct(rec: Record) -> float | None:
    """The share (%) of the completed requests' ``transport.to_host``
    bytes whose span says ``reused``.  A span a request carries twice
    counts once, as in :func:`tomobench.copies.copies`."""
    nbytes = reused = 0
    marked = False
    for r in rec.done():
        for _, _, b, hit in {(s.start, s.end, int(s.attrs["bytes"]),
                              s.attrs.get("reused"))
                             for s in r.spans if s.name == TO_HOST}:
            nbytes += b
            reused += b if hit is True else 0
            marked |= hit is not None
    return None if not marked or nbytes <= 0 else 100.0 * reused / nbytes
