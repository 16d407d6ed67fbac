"""backproject_roofline: the frozen least time of the window's
backprojection steps (``yardsticks.backprojection`` at each step's
shapes, on the cell's cards at the data-sheet float32 and HBM peaks)
over the summed ``plugin.fbp_recon.process`` spans, in %."""
from tomobench import yardsticks
from tomobench.readers import step_spans


def read(rec):
    least = took = 0.0
    for r in rec.done():
        steps, work = step_spans(r, "fbp_recon"), r.work.get("fbp", [])
        if not steps or len(steps) != len(work):
            continue
        for (s, e), w in zip(steps, work):
            least += yardsticks.least_seconds(
                yardsticks.backprojection(w["slices"], w["angles"],
                                          w["n_det"], w["out_size"]),
                rec.chips)
            took += e - s
    return None if took <= 0 else 100.0 * least / took
