"""Arithmetic of the readers of the ``staged`` attribute of the
program's ``transport.to_device`` spans: whether a raw band or scan
handed to the cards went through page-locked staging blocks.  A
program whose spans lack the attribute gives every reader None."""
from __future__ import annotations

from .copies import TO_DEVICE
from .record import Record


def staged_pct(rec: Record) -> float | None:
    """The share (%) of the completed requests' ``transport.to_device``
    bytes whose span says ``staged``.  A span a request carries twice
    counts once, as in :func:`tomobench.copies.copies`."""
    nbytes = staged = 0
    marked = False
    for r in rec.done():
        for _, _, b, hit in {(s.start, s.end, int(s.attrs["bytes"]),
                              s.attrs.get("staged"))
                             for s in r.spans if s.name == TO_DEVICE}:
            nbytes += b
            staged += b if hit is True else 0
            marked |= hit is not None
    return None if not marked or nbytes <= 0 else 100.0 * staged / nbytes
