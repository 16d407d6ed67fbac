"""The metric readers' arithmetic on hand-made records."""
from __future__ import annotations

import pytest

from tomobench import bench, yardsticks
from tomobench.devtrace import UNCOVERED, _innermost_segments
from tomobench.record import (DeviceSummary, Record, Request, Span, merged,
                              quantile, union_seconds)


def req(i, due, start, end, ok=True, slices=16, spans=(), work=None):
    return Request(i, due, start, end, ok, slices if ok else 0,
                   list(spans), work or {})


def read(name, rec):
    return bench.reader(name).read(rec)


def test_quantile_union_merged():
    assert quantile([], 0.9) is None
    assert quantile(range(1, 101), 0.90) == 90
    assert quantile(range(1, 101), 0.95) == 95
    assert quantile([3.0], 0.5) == 3.0
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_seconds([(0, 2), (1, 3)], 1.5, 2.5) == 1.0
    assert merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_slices_per_s_counts_whole_requests_to_the_last_completion():
    rec = Record("c", 1, 100.0, 104.0,
                 [req(0, 100, 100, 102), req(1, 102, 102, 104),
                  req(2, 104, 104, 104.5, ok=False)])
    assert read("slices_per_s", rec) == pytest.approx(32 / 4.0)


def test_slices_per_s_of_an_open_loop_counts_what_ended_by_the_close():
    # an open loop's window ends at its close: the request that was
    # still queued then (ending at 106) completes nothing inside it
    rec = Record("c", 1, 100.0, 105.0,
                 [req(0, 100, 100, 102), req(1, 101, 102, 104.5),
                  req(2, 104, 104.5, 106)])
    assert read("slices_per_s", rec) == pytest.approx(32 / 5.0)


def test_outside_steps_share():
    spans = [Span("plugin.a.process", 1.0, 2.0),
             Span("plugin.b.process", 1.5, 3.0),
             Span("plugin.a.setup", 0.0, 1.0),
             Span("queue.wait", 0.0, 4.0)]
    rec = Record("c", 1, 0, 4, [req(0, 0, 0.0, 4.0, spans=spans)])
    # 2 of the 4 s are under process spans
    assert read("runner.outside_steps_pct.chain", rec) == pytest.approx(50)
    assert read("runner.outside_steps_pct.service", rec) == pytest.approx(50)


def test_queue_wait_p95():
    spans = [Span("queue.wait", 0, w / 100) for w in range(1, 101)]
    rec = Record("c", 1, 0, 1, [req(0, 0, 0, 1, spans=spans)])
    assert read("service.queue_wait_p95_s", rec) == pytest.approx(0.95)


def test_backproject_roofline_from_the_frozen_count():
    w = {"slices": 16, "angles": 1801, "n_det": 2560, "out_size": 2560}
    least = yardsticks.least_seconds(
        yardsticks.backprojection(16, 1801, 2560, 2560), 1)
    spans = [Span("plugin.fbp_recon.process", 1.0, 1.0 + 4 * least)] * 4
    rec = Record("c", 1, 0, 2, [req(0, 0, 0, 2, spans=spans,
                                    work={"fbp": [w]})])
    # a gang's members carry the one shared step: counted once
    assert read("backproject_roofline", rec) == pytest.approx(25.0)
    rec.chips = 4
    assert read("backproject_roofline", rec) == pytest.approx(6.25)
    assert read("backproject_roofline",
                Record("c", 1, 0, 1, [req(0, 0, 0, 1)])) is None


def test_correction_raw_gbps_and_alltoall():
    spans = [Span("plugin.dark_flat_correction.process", 0.0, 0.5)]
    rec = Record("c", 1, 0, 1, [req(0, 0, 0, 1, spans=spans,
                                    work={"raw_bytes": 2e9})])
    assert read("correction.raw_gbps", rec) == pytest.approx(4.0)
    assert read("transport.alltoall_gbps", rec) is None
    rec.stats = {"alltoall_bytes": 3e9, "alltoall_s": 0.01}
    assert read("transport.alltoall_gbps", rec) == pytest.approx(300.0)


def test_idle_share_averaged_over_cards():
    rec = Record("c", 2, 0, 10, [])
    assert read("device.idle_pct.chain", rec) is None
    rec.device = DeviceSummary([6.0, 8.0], 10.0, [], [])
    assert read("device.idle_pct.chain", rec) == pytest.approx(30.0)
    assert read("device.idle_pct.service", rec) == pytest.approx(30.0)


def test_setup_s():
    rec = Record("c", 1, 0, 1, [])
    rec.setup_s = 12.5
    assert read("setup_s", rec) == 12.5


def test_idle_gaps_are_named_by_the_innermost_span():
    at, names = _innermost_segments([Span("request", 0, 10),
                                     Span("transport.read", 6, 9),
                                     Span("plugin.x.setup", 1, 2)])
    def name_at(t):
        i = max(k for k, a in enumerate(at) if a <= t * 1e9)
        return names[i]
    assert name_at(0.5) == "request"
    assert name_at(1.5) == "plugin.x.setup"
    assert name_at(7) == "transport.read"
    assert name_at(9.5) == "request"
    assert name_at(11) == UNCOVERED
