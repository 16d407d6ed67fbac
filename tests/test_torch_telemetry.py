"""End-to-end telemetry in the port against tests/test_telemetry.py: the
cross-process trace and the ``/metrics`` exposition, on the CPU at
16 x 8 x 1.

Scheduler mode: a submitted job's ``GET /jobs/{id}/trace`` shows the
full timeline (queue.wait + per-plugin spans under one trace_id), the
ASCII gantt renders, ``GET /metrics`` is Prometheus-parseable and
carries every catalogued metric including ``job_latency_e2e``
quantiles, and ``/stats`` carries ``metrics``/``queue`` blocks.

Broker mode: a job SIGKILLed mid-chain on one worker process and resumed
on the survivor returns ONE contiguous timeline with spans from BOTH
worker ids — the victim's history arrived via heartbeat piggybacking
before the kill, the broker's lease spans bracket both attempts."""
import importlib
import os
import signal
import time
import urllib.request

import pytest

from repro_torch.obs import catalogue_names, prometheus_name
from repro_torch.service import (PipelineClient, PipelineService,
                                 ServiceError, wire)
from repro_torch.service.worker import spawn_local_workers
from repro_torch.tomo import standard_chain

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
N = dict(n_det=16, n_angles=8, n_rows=1, device="cpu")


@pytest.fixture
def service():
    """A scheduler-mode service (in-process workers) on an ephemeral
    port, plus its URL and a client."""
    svc = PipelineService(device="cpu", n_workers=2)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=30.0)
    try:
        yield svc, client, url
    finally:
        svc.stop()


# ================================================= scheduler-mode trace
def test_trace_endpoint_scheduler_mode(service):
    svc, client, url = service
    jid = client.submit(standard_chain(**N, seed=0))
    snap = client.wait(jid, timeout=300)
    assert snap["state"] == "done", snap
    assert snap["trace_id"]

    doc = client.trace(jid)
    assert doc["job_id"] == jid
    assert doc["trace_id"] == snap["trace_id"]
    spans = doc["spans"]
    names = [s["name"] for s in spans]
    assert "queue.wait" in names
    # per-plugin process spans for the whole chain
    proc = [s for s in spans
            if s["name"].startswith("plugin.")
            and s.get("attrs", {}).get("phase") == "process"]
    assert len(proc) >= snap["n_plugins"]
    for s in spans:
        assert s["end"] is not None and s["end"] >= s["start"]
    # start-ordered: one contiguous timeline
    starts = [s["start"] for s in spans]
    assert starts == sorted(starts)

    # the Fig-9-style ASCII gantt
    text = client.trace(jid, text=True)
    assert "timeline" in text
    assert "queue.wait" in text and "#" in text

    with pytest.raises(ServiceError):          # unknown job -> 404
        client.trace("no-such-job")


def test_metrics_endpoint_prometheus(service):
    svc, client, url = service
    jid = client.submit(standard_chain(**N, seed=1))
    assert client.wait(jid, timeout=300)["state"] == "done"

    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
        ctype = resp.headers.get("Content-Type")
        text = resp.read().decode("utf-8")
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    # every catalogued metric is exposed, even if never touched
    for name in catalogue_names():
        assert prometheus_name(name) in text, name
    # the acceptance metric: e2e latency quantiles from a real job
    assert 'job_latency_e2e{quantile="0.5"}' in text
    assert 'job_latency_e2e{quantile="0.99"}' in text
    assert "job_latency_e2e_count 1" in text
    assert "jobs_submitted 1" in text
    assert "jobs_completed 1" in text
    # parseable: every sample line is `name[{labels}] value`
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            float(line.rpartition(" ")[2])
    assert "jobs_completed" in client.metrics()


def test_stats_carries_metrics_and_queue_age(service):
    svc, client, url = service
    st = client.stats()
    assert "metrics" in st and "queue" in st
    q = st["queue"]
    assert set(q) >= {"depth", "by_priority", "oldest_pending_age"}
    assert q["depth"] == 0 and q["oldest_pending_age"] is None
    jid = client.submit(standard_chain(**N, seed=2))
    client.wait(jid, timeout=300)
    snap = client.stats()["metrics"]
    assert snap["jobs.completed"] >= 1
    assert snap["job.latency.e2e"]["count"] >= 1
    assert snap["job.latency.e2e"]["p50"] > 0


# ============================================= broker-mode (acceptance)
def test_trace_spans_survive_kill_and_resume(tmp_path, monkeypatch):
    """Kill the worker holding the lease mid-chain; after the job
    resumes and finishes on the second worker, ONE trace holds spans
    from BOTH worker ids: the victim's plugin spans (shipped by
    heartbeat before the kill), the broker's two lease spans (expired +
    done), and the survivor's resumed attempt."""
    monkeypatch.setattr(wire, "_REGISTRY", dict(wire._REGISTRY))
    for cls in importlib.import_module("torch_slow_plugins").PLUGINS:
        wire.register_plugin(cls)
    ckpt = str(tmp_path / "ckpts")
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=1.5,
                          sweep_interval=0.1)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=60.0)
    spec = {"version": 1, "plugins": [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": 16, "n_angles": 8, "n_rows": 1, "seed": 5},
         "out_datasets": ["tomo"]},
        {"plugin": "dark_flat_correction", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "slow_identity", "params": {"delay": 2.0},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]}
    workers = spawn_local_workers(
        url, 2, transport="cuda", device="cpu", checkpoint_dir=ckpt,
        poll=0.05, heartbeat=0.3, imports=("torch_slow_plugins",),
        worker_ids=["w0", "w1"], pythonpath_extra=(TESTS_DIR,))
    by_id = dict(zip(["w0", "w1"], workers))
    try:
        jid = client.submit(spec, job_id="traced-crash-job")
        deadline = time.time() + 120
        while True:
            snap = client.status(jid)
            if snap["state"] == "running" and snap["plugin_index"] >= 1 \
                    and snap["worker_id"]:
                break
            assert snap["state"] not in ("done", "failed"), snap
            assert time.time() < deadline, f"never got mid-chain: {snap}"
            time.sleep(0.05)
        victim = snap["worker_id"]
        time.sleep(0.7)          # a heartbeat ships the finished steps
        os.kill(by_id[victim].pid, signal.SIGKILL)

        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done", snap
        survivor = snap["worker_id"]
        assert survivor != victim and snap["attempt"] >= 2, snap

        doc = client.trace(jid)
        assert doc["trace_id"] == snap["trace_id"]
        spans = doc["spans"]
        starts = [s["start"] for s in spans]
        assert starts == sorted(starts)
        owners = {s.get("worker_id") for s in spans} - {None}
        assert {victim, survivor} <= owners, owners
        # the victim's pre-kill plugin history made it out via heartbeat
        victim_plugins = [s for s in spans
                          if s.get("worker_id") == victim
                          and s["name"].startswith("plugin.")]
        assert victim_plugins, [s["name"] for s in spans]
        # the broker bracketed both attempts with lease spans
        leases = [s for s in spans if s["name"] == "lease"]
        assert len(leases) >= 2
        outcomes = {s["attrs"]["outcome"] for s in leases}
        assert "expired" in outcomes and "done" in outcomes
        assert {s["worker_id"] for s in leases} == {victim, survivor}
        # the survivor's attempt span records the retry number
        attempts = [s for s in spans if s["name"] == "attempt"]
        assert any(s.get("worker_id") == survivor
                   and s["attrs"]["attempt"] >= 2 for s in attempts)

        text = client.trace(jid, text=True)
        assert "timeline" in text and victim in text and survivor in text

        # lease-expiry accounting reached the metrics registry
        snap_m = client.stats()["metrics"]
        assert snap_m["lease.expired"] >= 1
        assert snap_m["jobs.requeued"] >= 1
        assert "lease_expired" in client.metrics()
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
        for p in workers:
            p.wait(timeout=10)
        svc.stop()
