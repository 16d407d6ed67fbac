"""paganin_roofline.phase: the frozen least time of the window's Paganin
steps (``yardsticks.paganin.retrieval`` at the ``frames``, ``fft_shape``
and ``pad`` that each ``plugin.paganin_filter.process`` span carries, on
the cell's cards at the data-sheet float32 and HBM peaks) over the
summed spans, in %.  A span without these attributes is not counted."""
from tomobench import yardsticks
from tomobench.yardsticks.paganin import retrieval

SPAN = "plugin.paganin_filter.process"


def read(rec):
    least = took = 0.0
    for r in rec.done():
        # a span a request carries twice (gang members) counts once
        steps = {(s.start, s.end): s.attrs for s in r.spans
                 if s.name == SPAN and {"frames", "fft_shape", "pad"}
                 <= set(s.attrs)}
        for (s, e), a in steps.items():
            least += yardsticks.least_seconds(
                retrieval(int(a["frames"]), *map(int, a["fft_shape"]),
                          *map(int, a["pad"])), rec.chips)
            took += e - s
    return None if took <= 0 else 100.0 * least / took
