"""The port's telemetry (obs/) against tests/test_obs.py: the
MetricsRegistry and EventLog cases that need no server, the span
context manager the service uses, the shipping half of the trace
(wire form, merge, spool), the Gantt rendering, the SLO engine and the
OTLP export, and the catalogue covering every metric the port creates.
The port's modules are copies (stdlib only), so the JAX package's
expectations hold unchanged; where a case renders or exports, the JAX
package's module gives the same document from the same input."""
import math
import os
import re
import threading
import time

import pytest

import repro.obs as JO

from repro_torch.obs import (CATALOGUE, Counter, EventLog, Gauge, Histogram,
                             MetricsRegistry, OtlpSpool, SloEngine, SloRule,
                             Span, Trace, TraceSpool, catalogue_names,
                             default_rules, iter_spans, metrics_to_otlp,
                             prometheus_name, register_catalogue,
                             render_gantt, rules_from_spec, trace_to_otlp)

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


# ================================================ trace shipping + gantt
def test_span_wire_roundtrip_matches_jax():
    s = Span("plugin.fbp.process", 10.0, 11.5, worker_id="w0",
             parent_id="abc", attrs={"phase": "process", "gang": 2})
    back = Span.from_wire(s.to_wire())
    assert back.name == s.name and back.span_id == s.span_id
    assert back.start == 10.0 and back.end == 11.5
    assert back.worker_id == "w0" and back.parent_id == "abc"
    assert back.attrs == s.attrs
    # the wire form is the JAX package's: each side reads the other's
    assert JO.Span.from_wire(s.to_wire()).to_wire() == s.to_wire()


def test_merge_dedups_and_ship_unship_protocol():
    tr = Trace("job-1")
    wire = [Span("lease", 1.0, 2.0, span_id="aaa").to_wire(),
            Span("plugin.x.process", 1.2, 1.8, span_id="bbb").to_wire()]
    assert [s.span_id for s in tr.merge(wire)] == ["aaa", "bbb"]
    assert tr.merge(wire) == [] and len(tr) == 2
    assert tr.merge([{"nonsense": True}, None]) == []
    tr = Trace()
    tr.record("a", 1.0, 2.0)
    open_span = tr.begin("b")                # unfinished: never shipped
    batch = tr.take_unshipped()
    assert [s.name for s in batch] == ["a"]
    assert tr.take_unshipped() == []
    tr.unship(batch)
    assert [s.name for s in tr.take_unshipped()] == ["a"]
    tr.finish(open_span)
    assert [s.name for s in tr.take_unshipped()] == ["b"]


def test_render_gantt_layout():
    spans = [Span("queue.wait", 0.0, 1.0),
             Span("plugin.fbp.process", 1.0, 3.0, worker_id="w1")]
    out = render_gantt(spans, width=40)
    lines = out.splitlines()
    assert "timeline" in lines[0] and "3.000s total" in lines[0]
    assert lines[1].startswith("queue.wait")
    assert "w1" in lines[2] and "#" in lines[2]
    assert render_gantt([]) == "(no spans)"
    assert out == JO.render_gantt(
        [JO.Span.from_wire(s.to_wire()) for s in spans], width=40)


def test_trace_spool_ring(tmp_path):
    spool = TraceSpool(str(tmp_path / "spool"), max_traces=2)
    for i in range(3):
        tr = Trace(f"t{i}")
        tr.record("a", 0.0, 1.0)
        spool.put(f"job/{i}", tr)
        os.utime(spool._path(f"job/{i}"), (i + 1, i + 1))
    spool.put("job/3", None)                 # "existed" beats a 404
    assert len(spool) == 2
    assert spool.get("job/0") is None and spool.get("job/1") is None
    assert spool.get("job/3") == {"job_id": "job/3", "trace_id": "",
                                  "spans": []}
    with pytest.raises(ValueError):
        TraceSpool(str(tmp_path / "x"), max_traces=0)


# =========================================================== SLO engine
def _jax_slo_events(drive):
    reg, log = JO.MetricsRegistry(), JO.EventLog()
    return drive(reg, JO.SloEngine(reg, events=log)), log


def test_slo_gauge_rule_full_lifecycle_with_holddowns():
    """ok -> pending -> (for_s held) firing -> (resolve_s held) ok, one
    event per transition, as the JAX package's engine walks it."""
    def drive(reg, eng):
        g = reg.gauge("queue.oldest_age_s")
        g.set(200.0)                         # rule: > 120 for 5s
        out = [eng.evaluate(now=1000.0), eng.evaluate(now=1004.0),
               eng.evaluate(now=1005.0)]
        g.set(10.0)
        out += [eng.evaluate(now=1006.0), eng.evaluate(now=1010.9),
                eng.evaluate(now=1011.0)]
        return out

    reg, log = MetricsRegistry(), EventLog()
    eng = SloEngine(reg, events=log)
    got = drive(reg, eng)
    assert got == [["alert.pending"], [], ["alert.firing"], [], [],
                   ["alert.resolved"]]
    assert got == _jax_slo_events(drive)[0]
    assert eng.n_firing() == 0
    names = [e["event"] for e in log.since(0)["events"]]
    assert names == ["alert.pending", "alert.firing", "alert.resolved"]
    for e in log.since(0)["events"]:
        assert e["trace_id"] == eng.trace_id
        assert e["attrs"]["rule"] == "queue-oldest-age"
    assert reg.counter("alerts.fired").value == 1
    assert reg.counter("alerts.resolved").value == 1
    (rule,) = [r for r in eng.snapshot()["rules"]
               if r["name"] == "queue-oldest-age"]
    assert rule["fired"] == 1 and rule["resolved"] == 1


def test_slo_pending_that_never_fires_folds_back_silently():
    reg, log = MetricsRegistry(), EventLog()
    eng = SloEngine(reg, events=log)
    g = reg.gauge("queue.oldest_age_s")
    g.set(500.0)
    assert eng.evaluate(now=0.0) == ["alert.pending"]
    g.set(0.0)
    assert eng.evaluate(now=1.0) == []
    assert eng.n_firing() == 0
    assert [e["event"] for e in log.since(0)["events"]] == \
        ["alert.pending"]
    assert reg.counter("alerts.fired").value == 0


def test_slo_rate_rule_fires_on_counter_increase_and_resolves():
    reg = MetricsRegistry()
    eng = SloEngine(reg, events=EventLog())
    c = reg.counter("lease.expired")
    assert eng.evaluate(now=0.0) == []
    c.inc()
    assert eng.evaluate(now=1.0) == ["alert.pending", "alert.firing"]
    (detail,) = eng.critical_firing()
    assert detail["name"] == "lease-expiry-rate" and detail["value"] == 1.0
    assert eng.evaluate(now=20.0) == []
    assert eng.n_firing() == 1
    assert eng.evaluate(now=32.0) == ["alert.resolved"]
    assert eng.critical_firing() == [] and eng.n_firing() == 0


def test_slo_quantile_rule_ignores_empty_histogram():
    reg = MetricsRegistry()
    eng = SloEngine(reg)
    reg.histogram("job.latency.e2e")
    assert eng.evaluate(now=0.0) == []
    for _ in range(3):
        reg.histogram("job.latency.e2e").observe(400.0)  # p99 > 300
    assert eng.evaluate(now=1.0) == ["alert.pending"]
    assert eng.evaluate(now=6.0) == ["alert.firing"]     # for_s=5


def test_slo_missing_metric_never_breaches():
    eng = SloEngine(MetricsRegistry())
    assert eng.evaluate(now=0.0) == []
    snap = eng.snapshot()
    assert all(r["state"] == "ok" and r["value"] is None
               for r in snap["rules"])
    jsnap = JO.SloEngine(JO.MetricsRegistry()).snapshot()
    assert [r["name"] for r in snap["rules"]] == \
        [r["name"] for r in jsnap["rules"]]


def test_rules_from_spec_patch_add_disable():
    assert [r.name for r in default_rules()] == \
        [r.name for r in JO.default_rules()]
    spec = {"lease-expiry-rate": {"window_s": 5.0},
            "my-depth": {"metric": "queue.depth", "threshold": 50.0,
                         "critical": True},
            "ingest-lag": None}
    rules = rules_from_spec(spec)
    by_name = {r.name: r for r in rules}
    assert by_name["lease-expiry-rate"].window_s == 5.0
    assert by_name["lease-expiry-rate"].critical is True
    assert by_name["my-depth"].metric == "queue.depth"
    assert "ingest-lag" not in by_name and len(rules) == 5
    assert [r.name for r in rules] == \
        [r.name for r in JO.rules_from_spec(spec)]


def test_rules_from_spec_rejects_bad_specs():
    with pytest.raises(ValueError):
        rules_from_spec({"queue-oldest-age": {"nope": 1}})
    with pytest.raises(ValueError):
        rules_from_spec({"queue-oldest-age": 42})
    with pytest.raises(ValueError):
        rules_from_spec({"new-rule": {"metric": "queue.depth"}})
    with pytest.raises(ValueError):
        SloRule("x", "m", 1.0, kind="nope")
    with pytest.raises(ValueError):
        SloRule("x", "m", 1.0, op=">=")


# ========================================================== OTLP export
def test_trace_to_otlp_maps_spans_one_to_one():
    s1 = Span("queue.wait", 1.0, 2.0, span_id="aaa1")
    s2 = Span("plugin.fbp.process", 2.0, 3.5, span_id="bbb2",
              parent_id="aaa1", worker_id="w0",
              attrs={"flops": 1e9, "gang": 2, "ok": True, "tag": "x"})
    doc = {"trace_id": "deadbeefdeadbeef",
           "spans": [s1.to_wire(), s2.to_wire()]}
    otlp = trace_to_otlp(doc, {"job.id": "j1"})
    assert otlp == JO.trace_to_otlp(doc, {"job.id": "j1"})
    spans = list(iter_spans(otlp))
    assert len(spans) == 2
    for s in spans:
        assert len(s["traceId"]) == 32
        assert s["traceId"].endswith("deadbeefdeadbeef")
        assert len(s["spanId"]) == 16
    proc = {s["name"]: s for s in spans}
    assert proc["plugin.fbp.process"]["parentSpanId"] == \
        "aaa1".rjust(16, "0")
    attrs = {a["key"]: a["value"]
             for a in proc["plugin.fbp.process"]["attributes"]}
    assert attrs["flops"] == {"doubleValue": 1e9}
    assert attrs["gang"] == {"intValue": "2"}
    assert attrs["ok"] == {"boolValue": True}
    assert attrs["tag"] == {"stringValue": "x"}
    procs = [{a["key"]: a["value"] for a in rs["resource"]["attributes"]}
             ["service.instance.id"]["stringValue"]
             for rs in otlp["resourceSpans"]]
    assert procs == ["broker", "w0"]


def test_trace_to_otlp_accepts_live_trace_and_open_spans():
    tr = Trace("job-7", worker_id="w1")
    with tr.span("attempt", attempt=1):
        tr.record("compile", 1.0, 2.0)
    open_span = tr.begin("lease")
    spans = list(iter_spans(trace_to_otlp(tr)))
    assert len(spans) == len(tr.spans()) == 3
    (lease,) = [s for s in spans if s["name"] == "lease"]
    assert lease["endTimeUnixNano"] == lease["startTimeUnixNano"]
    tr.finish(open_span)


def test_otlp_id_handles_non_hex_ids():
    doc = {"trace_id": "not hex at all!", "spans": [
        Span("a", 0.0, 1.0, span_id="zzz").to_wire()]}
    one = list(iter_spans(trace_to_otlp(doc)))[0]
    two = list(iter_spans(trace_to_otlp(doc)))[0]
    assert one["traceId"] == two["traceId"]
    int(one["traceId"], 16)
    assert len(one["traceId"]) == 32 and len(one["spanId"]) == 16


def test_metrics_to_otlp_shapes():
    snap = {"jobs.completed": 3, "queue.depth": 2.5,
            "bad.scrape": float("nan"),
            "job.latency.e2e": {"count": 3, "sum": 0.6, "p50": 0.2,
                                "p95": 0.3, "p99": 0.3},
            "not_a_metric": "text", "flag": True}
    otlp = metrics_to_otlp(snap, identity="w9", now=100.0)
    want = JO.metrics_to_otlp(snap, identity="w9", now=100.0)
    # NaN != NaN: compare the documents as JSON text
    import json
    assert json.dumps(otlp, sort_keys=True) == json.dumps(
        want, sort_keys=True)
    (rm,) = otlp["resourceMetrics"]
    metrics = {m["name"]: m for m in rm["scopeMetrics"][0]["metrics"]}
    assert set(metrics) == {"jobs.completed", "queue.depth",
                            "bad.scrape", "job.latency.e2e"}
    assert metrics["jobs.completed"]["sum"]["isMonotonic"] is True
    assert metrics["bad.scrape"]["gauge"]["dataPoints"] == []


def test_otlp_spool_write_sanitise_evict(tmp_path):
    import json
    spool = OtlpSpool(str(tmp_path / "otlp"), max_files=2)
    tr = Trace("job-1")
    tr.record("a", 0.0, 1.0)
    p1 = spool.export_trace("job/../1 x", tr)
    assert os.path.basename(p1) == "trace-job_.._1_x.otlp.json"
    with open(p1) as fh:
        assert len(list(iter_spans(json.load(fh)))) == 1
    p2 = spool.put("two", {"resourceSpans": []})
    os.utime(p1, (1, 1))
    os.utime(p2, (2, 2))
    p3 = spool.put("three", {"resourceSpans": []})
    assert len(spool) == 2
    assert not os.path.exists(p1)
    assert os.path.exists(p2) and os.path.exists(p3)
    with pytest.raises(ValueError):
        OtlpSpool(str(tmp_path / "x"), max_files=0)
