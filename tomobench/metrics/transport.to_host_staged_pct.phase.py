"""transport.to_host_staged_pct.phase: the share (%) of the bytes of the
``transport.to_host`` spans (each whole ROI's volume read off the card)
whose span says ``staged``: a volume too large for a page-locked block
of its own, read into fresh pageable memory through recycled
page-locked staging blocks on several host lanes.  A span a request
carries twice counts once, as in :func:`tomobench.copies.copies`.  A
program whose spans carry no ``staged`` reads nothing."""
from tomobench.copies import TO_HOST


def read(rec):
    nbytes = staged = 0
    marked = False
    for r in rec.done():
        for _, _, b, hit in {(s.start, s.end, int(s.attrs["bytes"]),
                              s.attrs.get("staged"))
                             for s in r.spans if s.name == TO_HOST}:
            nbytes += b
            staged += b if hit is True else 0
            marked |= hit is not None
    return None if not marked or nbytes <= 0 else 100.0 * staged / nbytes
