"""correction.raw_gbps: raw uint16 bytes over the summed
``plugin.dark_flat_correction.process`` spans, GB/s (the span holds the
raw's host-to-device copy)."""
from tomobench.readers import step_spans


def read(rec):
    nbytes = took = 0.0
    for r in rec.done():
        steps = step_spans(r, "dark_flat_correction")
        if not steps:
            continue
        nbytes += r.work["raw_bytes"]
        took += sum(e - s for s, e in steps)
    return None if took <= 0 else nbytes / took / 1e9
