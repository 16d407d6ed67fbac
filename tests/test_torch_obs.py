"""The port's telemetry (obs/) against tests/test_obs.py: the
MetricsRegistry and EventLog cases that need no server, the span
context manager the service uses, and the catalogue covering every
metric the port creates.  The port's modules are copies (stdlib only),
so the JAX package's expectations hold unchanged."""
import math
import os
import re
import threading
import time

import pytest

import repro.obs as JO

from repro_torch.obs import (CATALOGUE, Counter, EventLog, Gauge, Histogram,
                             MetricsRegistry, Trace, catalogue_names,
                             prometheus_name, register_catalogue)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ============================================================== tracing
def test_span_context_manager_nests_parent_links():
    tr = Trace("t1", worker_id="w0")
    with tr.span("attempt", attempt=1) as outer:
        with tr.span("plugin.fbp.process") as inner:
            pass
    assert inner.parent_id == outer.span_id
    assert outer.parent_id is None
    assert outer.end is not None and inner.end is not None
    assert outer.attrs == {"attempt": 1} and outer.wall >= inner.wall
    assert all(s.worker_id == "w0" for s in tr.spans())
    assert len(tr.spans()) == 2


def test_span_error_attr_on_exception():
    tr = Trace()
    with pytest.raises(RuntimeError):
        with tr.span("attempt"):
            raise RuntimeError("boom")
    (s,) = tr.spans()
    assert s.attrs["error"] == "RuntimeError" and s.end is not None


def test_record_defaults_parent_to_open_span():
    tr = Trace()
    with tr.span("plugin.fbp.process") as p:
        tr.record("compile", time.time() - 1, time.time())
    compile_span = [s for s in tr.spans() if s.name == "compile"][0]
    assert compile_span.parent_id == p.span_id


# ============================================================== metrics
def test_counter_monotonic():
    c = Counter("jobs.completed")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_callback_and_error_isolation():
    g = Gauge("queue.depth", fn=lambda: 7)
    assert g.value == 7.0
    g2 = Gauge("bad")
    g2.set(3)
    assert g2.value == 3.0
    g2.set_function(lambda: 1 / 0)           # scrape must not raise
    assert math.isnan(g2.value)


def test_histogram_exact_count_sum_and_quantiles():
    h = Histogram("lat", reservoir_size=100)
    for v in range(100):
        h.observe(v)
    assert h.count == 100 and h.sum == pytest.approx(4950.0)
    assert h.quantile(0.0) == 0
    assert h.quantile(1.0) == 99
    assert h.quantile(0.5) == 50
    with pytest.raises(ValueError):
        h.quantile(1.5)
    assert Histogram("empty").quantile(0.5) is None


def test_histogram_reservoir_bounds_memory():
    h = Histogram("lat", reservoir_size=64, seed=1)
    for v in range(10_000):
        h.observe(float(v))
    assert len(h._reservoir) == 64
    assert h.count == 10_000
    # the sample stays representative: median of U[0, 10k) within 25%
    assert 2_500 <= h.quantile(0.5) <= 7_500


def test_histogram_quantile_properties_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=200, deadline=None)
    @given(st.lists(st.floats(allow_nan=False, allow_infinity=False,
                              width=32),
                    min_size=1, max_size=200),
           st.floats(min_value=0.0, max_value=1.0))
    def prop(values, q):
        h = Histogram("x", reservoir_size=1000)
        for v in values:
            h.observe(v)
        got = h.quantile(q)
        # every quantile is an actual observation, bracketed by min/max,
        # and monotone in q
        assert got in [float(v) for v in values]
        assert min(values) <= got <= max(values)
        assert h.quantile(0.0) == min(values)
        assert h.quantile(1.0) == max(values)
        qs = [h.quantile(x) for x in (0.0, 0.25, 0.5, 0.75, 1.0)]
        assert qs == sorted(qs)

    prop()


def test_registry_get_or_create_and_kind_conflict():
    reg = MetricsRegistry()
    c1 = reg.counter("jobs.completed")
    assert reg.counter("jobs.completed") is c1
    with pytest.raises(ValueError):
        reg.gauge("jobs.completed")
    reg.histogram("job.latency.e2e").observe(1.0)
    snap = reg.snapshot()
    assert snap["jobs.completed"] == 0
    assert snap["job.latency.e2e"]["count"] == 1
    assert snap["job.latency.e2e"]["p50"] == 1.0


def test_prometheus_rendering_format():
    reg = MetricsRegistry()
    reg.counter("jobs.completed", help="done jobs").inc(3)
    reg.gauge("queue.depth").set(2)
    h = reg.histogram("job.latency.e2e")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    text = reg.render_prometheus()
    assert "# HELP jobs_completed done jobs" in text
    assert "# TYPE jobs_completed counter" in text
    assert "jobs_completed 3" in text
    assert "queue_depth 2" in text
    assert "# TYPE job_latency_e2e summary" in text
    assert 'job_latency_e2e{quantile="0.5"} 0.2' in text
    assert "job_latency_e2e_count 3" in text
    assert text.endswith("\n")
    # every line is a comment or `name[{labels}] value`
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        assert name and not name[0].isdigit()
        float(value)


def test_prometheus_name_sanitisation():
    assert prometheus_name("job.latency.e2e") == "job_latency_e2e"
    assert prometheus_name("plugin.wall.fbp-recon") == "plugin_wall_fbp_recon"
    assert prometheus_name("9lives") == "_9lives"


def test_catalogue_registers_every_name():
    reg = MetricsRegistry()
    register_catalogue(reg)
    assert set(catalogue_names()) <= set(reg.names())
    assert len(CATALOGUE) == len(set(catalogue_names()))
    text = reg.render_prometheus()
    for name in catalogue_names():
        assert prometheus_name(name) in text
    register_catalogue(reg)                  # idempotent


# ==================================================== completeness guard
#: per-plugin metrics minted from plugin names at runtime
DYNAMIC_METRIC_PREFIXES = ("plugin.wall.", "plugin.flops.")
_METRIC_CALL_RE = re.compile(
    r"""\.(counter|gauge|histogram)\(\s*["']([^"']+)["']""")


#: metrics of the port that the JAX package's catalogue has not
PORT_ONLY = {"gang.fallback"}


def test_catalogue_matches_jax_catalogue():
    """The JAX package's catalogue in its order, plus the port's own."""
    assert [e for e in CATALOGUE if e[0] not in PORT_ONLY] == list(
        JO.CATALOGUE)
    assert PORT_ONLY <= set(catalogue_names())


def test_every_metric_the_port_creates_is_catalogued():
    """Every literal metric name the port creates is pre-registered with
    the catalogued kind (the catalogue also names the front end's
    metrics, which arrive with the front-end slice)."""
    src = os.path.join(REPO_ROOT, "src", "repro_torch")
    used: dict[str, set[str]] = {}
    for root, _, files in os.walk(src):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(root, fname)) as fh:
                    for kind, name in _METRIC_CALL_RE.findall(fh.read()):
                        used.setdefault(name, set()).add(kind)
    cat = {name: kind for name, kind, _ in CATALOGUE}
    assert {"jobs.completed", "stream.window_latency_s",
            "stream.ingest_lag_s"} <= set(used)
    for name, kinds in used.items():
        if name.startswith(DYNAMIC_METRIC_PREFIXES):
            continue
        assert name in cat, name
        assert kinds == {cat[name]}, (name, kinds)


# ============================================================ event log
def test_eventlog_emit_since_and_cursor():
    log = EventLog(max_events=16)
    assert log.head == 0 and len(log) == 0
    log.emit("job.submit", trace_id="t1", job_id="j1", priority=5)
    log.emit("job.lease", trace_id="t1", job_id="j1", worker_id="w0")
    page = log.since(0)
    assert [e["event"] for e in page["events"]] == ["job.submit",
                                                   "job.lease"]
    assert page["cursor"] == 2 and page["dropped"] == 0
    rec = page["events"][0]
    assert rec["trace_id"] == "t1" and rec["job_id"] == "j1"
    assert rec["worker_id"] == "" and rec["attrs"] == {"priority": 5}
    assert rec["seq"] == 1 and rec["ts"] <= time.time()
    # resuming from the cursor sees only what is new
    assert log.since(page["cursor"])["events"] == []
    assert log.since(page["cursor"])["cursor"] == page["cursor"]
    log.emit("job.complete", trace_id="t1", job_id="j1")
    nxt = log.since(page["cursor"])
    assert [e["event"] for e in nxt["events"]] == ["job.complete"]
    assert nxt["cursor"] == 3 and log.head == 3


def test_eventlog_ring_reports_dropped_gap():
    log = EventLog(max_events=4)
    for i in range(10):
        log.emit("e", trace_id=f"t{i}")
    page = log.since(0)                  # seqs 7..10 retained
    assert [e["seq"] for e in page["events"]] == [7, 8, 9, 10]
    assert page["dropped"] == 6          # 1..6 fell off unseen
    # a reader who already saw seq 8 lost nothing
    assert log.since(8)["dropped"] == 0
    assert [e["seq"] for e in log.since(8)["events"]] == [9, 10]


def test_eventlog_limit_and_validation():
    log = EventLog(max_events=8)
    for _ in range(5):
        log.emit("e")
    page = log.since(0, limit=2)
    assert [e["seq"] for e in page["events"]] == [1, 2]
    assert page["cursor"] == 2           # paging resumes mid-ring
    with pytest.raises(ValueError):
        log.since(-1)
    with pytest.raises(ValueError):
        EventLog(max_events=0)
