"""Arithmetic of the readers of the program's copy spans
(``transport.to_device``: host data handed to the transport's device;
``transport.to_host``: a volume read off it into host memory): their
rate, and the share of the requests' walls that neither a step nor a
copy covers.  A program without these spans gives every reader None."""
from __future__ import annotations

from .readers import PROCESS
from .record import Record, Request, union_seconds

TO_DEVICE = "transport.to_device"
TO_HOST = "transport.to_host"


def copies(r: Request, name: str) -> list[tuple[float, float, int]]:
    """The distinct ``name`` spans of a request as (start, end, bytes):
    a span a request carries twice (a gang's members each holding the
    one shared interval) counts once."""
    return sorted({(s.start, s.end, int(s.attrs["bytes"]))
                   for s in r.spans if s.name == name})


def gbps(rec: Record, name: str) -> float | None:
    """The bytes of the completed requests' ``name`` spans over their
    summed walls, GB/s."""
    nbytes = took = 0.0
    for r in rec.done():
        for s, e, b in copies(r, name):
            nbytes += b
            took += e - s
    return None if took <= 0 else nbytes / took / 1e9


def host_pct(rec: Record) -> float | None:
    """The share (%) of the completed requests' summed walls that no
    ``plugin.*.process`` span and no copy span of the request covers
    (their union, clipped to the request): the runner's own host work,
    its set-up, and the waits between them."""
    wall = host = 0.0
    read = False
    for r in rec.done():
        busy = [(s.start, s.end) for s in r.spans
                if s.name in (TO_DEVICE, TO_HOST)
                or (s.name.startswith("plugin.") and s.name.endswith(PROCESS))]
        read |= any(s.name == TO_HOST for s in r.spans)
        w = r.end - r.start
        wall += w
        host += w - union_seconds(busy, r.start, r.end)
    return None if not read or wall <= 0 else 100.0 * host / wall
