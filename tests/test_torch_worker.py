"""Multi-host scheduling in the port: one queue, many worker PROCESSES,
against tests/test_worker.py, on the CPU (``--device cpu``) at 16 x 8 x 1.

A broker-mode ``PipelineService`` on an ephemeral port and two
``repro_torch.service.worker`` subprocesses pulling jobs over HTTP: a job
SIGKILLed mid-chain on one worker finishes on the survivor — resumed
from its checkpoint (``resumed_from`` set) — bit for bit equal to a
single-process ``PluginRunner``.  Plus the lease state machine (expiry →
requeue → exactly one owner; cancel-during-lease → ``cancelled``
verdict), capability filters and their starvation regression on
``JobQueue``, shared-fs hand-off, in-process workers.  Against the JAX
package: one spec through the port's broker and a worker process gives
the JAX ``PluginRunner``'s volume within the chain's bound (rtol 1e-3,
atol 1e-4), and the port's worker serves the JAX broker and the JAX
worker the port's broker (``docs/worker-protocol.md``).
"""
import importlib
import os
import signal
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro.service as JS

from repro_torch.core import (PROJECTION, BaseFilter, CudaTransport,
                              InMemoryTransport, PluginRunner)
from repro_torch.service import (JobQueue, PipelineClient, PipelineService,
                                 PipelineWorker, ServiceError,
                                 chain_plugin_names, from_spec, wire)
from repro_torch.service.worker import spawn_local_workers

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
#: the standard chain's wire names — a worker WITHOUT slow_identity
PLAIN_CAPS = ["synthetic_tomo_loader", "dark_flat_correction",
              "fbp_recon", "hdf5_saver"]
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def slow_plugins(monkeypatch):
    """The test plugins (``torch_slow_plugins``) in a copy of the wire
    registry, so the broker admits their chains; the process-wide
    registry is restored afterwards."""
    monkeypatch.setattr(wire, "_REGISTRY", dict(wire._REGISTRY))
    for cls in importlib.import_module("torch_slow_plugins").PLUGINS:
        wire.register_plugin(cls)


def _spec(seed=0, delay=0.0, n_det=16, n_angles=8):
    """A small wire spec; ``delay`` > 0 inserts the slow_identity
    plugin (sleeps per call) so a worker can be killed mid-chain."""
    plugins = [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": n_det, "n_angles": n_angles, "n_rows": 1,
                    "seed": seed},
         "out_datasets": ["tomo"]},
        {"plugin": "dark_flat_correction",
         "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
    ]
    if delay:
        plugins.append({"plugin": "slow_identity",
                        "params": {"delay": delay},
                        "in_datasets": ["tomo"], "out_datasets": ["tomo"]})
    plugins += [
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]
    return {"version": 1, "plugins": plugins}


def _reference(spec, transport=CudaTransport) -> np.ndarray:
    """The single-process path for the same spec, on the CPU."""
    r = PluginRunner(from_spec(spec, device="cpu"), transport("cpu"))
    return r.transport.read(r.run()["recon"])


def _jax_reference(spec) -> np.ndarray:
    r = R.PluginRunner(JS.from_spec(spec), R.InMemoryTransport())
    return np.asarray(r.transport.read(r.run()["recon"]))


def _spawn(url, n, **kw):
    return spawn_local_workers(url, n, transport="cuda", device="cpu",
                               pythonpath_extra=(TESTS_DIR,), **kw)


def _reap(workers):
    for p in workers:
        if p.poll() is None:
            p.kill()
    for p in workers:
        p.wait(timeout=10)


@pytest.fixture
def broker():
    """A broker-mode service on an ephemeral port + client (fast lease
    expiry so the race tests run in milliseconds)."""
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=0.4,
                          sweep_interval=0.05)
    host, port = svc.serve(port=0)
    client = PipelineClient(f"http://{host}:{port}", timeout=30.0)
    try:
        yield svc, client
    finally:
        svc.stop()


# ===================================================== kill/resume (E2E)
def test_worker_crash_job_resumes_on_survivor(tmp_path):
    """SIGKILL the worker holding the lease mid-chain: the lease
    expires, the job requeues, the surviving worker restores the shared
    checkpoint (resumed_from > 0) and finishes — bit for bit the
    single-process run."""
    ckpt = str(tmp_path / "ckpts")
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=1.5,
                          sweep_interval=0.1)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=60.0)
    workers = _spawn(url, 2, checkpoint_dir=ckpt, poll=0.05,
                     heartbeat=0.3, imports=("torch_slow_plugins",),
                     worker_ids=["w0", "w1"])
    by_id = dict(zip(["w0", "w1"], workers))
    try:
        spec = _spec(seed=5, delay=2.0)
        jid = client.submit(spec, job_id="crash-job")
        # wait until mid-chain: >=1 plugin done (so a checkpoint
        # exists) and the slow plugin is running on a known worker
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
        os.kill(by_id[victim].pid, signal.SIGKILL)

        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done", snap
        assert snap["resumed_from"] > 0, snap
        assert snap["worker_id"] != victim, snap
        assert snap["attempt"] >= 2, snap
        np.testing.assert_array_equal(client.result(jid),
                                      _reference(spec))
        st = client.stats()
        assert st["jobs_requeued"] >= 1
        assert st["leases_expired"] >= 1

        # the survivor keeps serving: a fresh job completes normally,
        # also bit for bit the single-process path
        spec2 = _spec(seed=6)
        jid2 = client.submit(spec2)
        snap2 = client.wait(jid2, timeout=120)
        assert snap2["state"] == "done", snap2
        assert snap2["worker_id"] != victim
        np.testing.assert_array_equal(client.result(jid2),
                                      _reference(spec2))
    finally:
        _reap(workers)
        svc.stop()


# ============================================ alert lifecycle (health plane)
def test_alert_lifecycle_on_worker_kill(tmp_path):
    """The health plane end-to-end: SIGKILL the worker holding a lease
    and watch the critical ``lease-expiry-rate`` rule walk the full
    alert lifecycle — ``/healthz?ready=1`` flips to 503 while it fires
    and back to 200 once the job resumes and the rate window slides
    past the expiry; the event log records exactly one firing and one
    resolved edge, and the job's own submit→lease→expire→requeue→
    complete chain shares one trace id."""
    svc = PipelineService(
        device="cpu", workers_remote=True, lease_ttl=1.0,
        sweep_interval=0.1, slo_interval=0.1,
        slo_spec={"lease-expiry-rate": {"window_s": 3.0}})
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=60.0)
    workers = _spawn(url, 1, poll=0.05, heartbeat=0.3,
                     imports=("torch_slow_plugins",), worker_ids=["w0"])
    try:
        assert client.health(ready=True)["ready"] is True
        jid = client.submit(_spec(seed=4, delay=2.0), job_id="slo-job")
        deadline = time.time() + 120
        while True:                      # wait until w0 holds the lease
            snap = client.status(jid)
            if snap["state"] == "running" and snap["worker_id"] == "w0":
                break
            assert snap["state"] not in ("done", "failed"), snap
            assert time.time() < deadline, snap
            time.sleep(0.05)
        os.kill(workers[0].pid, signal.SIGKILL)

        # lease expires -> the critical rule fires -> readiness is 503
        # with a machine-readable reason
        while True:
            health = client.health(ready=True)
            if not health["ready"]:
                break
            assert time.time() < deadline, "rule never fired"
            time.sleep(0.05)
        assert "lease-expiry-rate" in health["firing"]
        assert health["error"] == "critical SLO rule firing"
        assert client.slo()["critical_firing"] == ["lease-expiry-rate"]

        # a replacement worker drains the requeued job...
        workers += _spawn(url, 1, poll=0.05, heartbeat=0.3,
                          imports=("torch_slow_plugins",),
                          worker_ids=["w1"])
        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done" and snap["attempt"] >= 2, snap
        # ...and once the rate window slides past the expiry the rule
        # resolves: readiness flips back to 200
        while True:
            health = client.health(ready=True)
            if health["ready"]:
                break
            assert time.time() < deadline, "rule never resolved"
            time.sleep(0.1)

        events = client.events()["events"]
        by_name = {}
        for e in events:
            by_name.setdefault(e["event"], []).append(e)
        fire = [e for e in by_name.get("alert.firing", [])
                if e["attrs"]["rule"] == "lease-expiry-rate"]
        resolved = [e for e in by_name.get("alert.resolved", [])
                    if e["attrs"]["rule"] == "lease-expiry-rate"]
        assert len(fire) == 1 and len(resolved) == 1, by_name
        assert fire[0]["trace_id"] and fire[0]["trace_id"] == \
            resolved[0]["trace_id"]
        # the job's full transition chain shares ONE trace id
        trace_id = by_name["job.submit"][0]["trace_id"]
        assert trace_id
        for name in ("job.submit", "job.lease", "lease.expire",
                     "job.requeue", "job.complete"):
            mine = [e for e in by_name.get(name, [])
                    if e["job_id"] == jid]
            assert mine, (name, sorted(by_name))
            assert all(e["trace_id"] == trace_id for e in mine), name
        assert by_name["lease.expire"][0]["worker_id"] == "w0"
        (done,) = [e for e in by_name["job.complete"]
                   if e["job_id"] == jid]
        assert done["worker_id"] == "w1"
        assert done["attrs"]["state"] == "done"
        assert all(e["trace_id"] for e in events)

        # the cluster scoreboard shows the dead worker's staleness, the
        # survivor with no active leases, and each worker's card and
        # transport
        cluster = client.cluster()
        by_worker = {w["worker_id"]: w for w in cluster["workers"]}
        assert set(by_worker) == {"w0", "w1"}
        assert by_worker["w1"]["jobs_done"] >= 1
        assert by_worker["w1"]["leases"] == []
        assert by_worker["w0"]["heartbeat_staleness_s"] > 1.0
        assert cluster["leases_expired"] >= 1
        assert by_worker["w1"]["device"] == "cpu"
        assert by_worker["w1"]["transport"] == "cuda"
    finally:
        _reap(workers)
        svc.stop()


# ================================================== lease state machine
def test_lease_expiry_exactly_one_owner(broker):
    """A heartbeat after expiry is rejected; after the requeue exactly
    one worker owns the job and the stale owner's complete/upload are
    discarded with 409."""
    svc, client = broker
    client.register_worker(worker_id="w1")
    client.register_worker(worker_id="w2")
    jid = client.submit(_spec(seed=1))
    leased = client.lease("w1")
    assert [d["job_id"] for d in leased] == [jid]
    assert leased[0]["attempt"] == 1
    assert leased[0]["process_list"]["plugins"][0]["params"]["seed"] == 1
    # double-lease of the same job is impossible while it is leased
    assert client.lease("w2") == []
    assert client.lease("w1") == []

    time.sleep(0.8)                      # ttl 0.4s: expired and swept
    assert client.progress(jid, "w1", plugin_index=1)["verdict"] == "lost"
    assert client.status(jid)["state"] in ("queued", "checking")

    l2 = client.lease("w2")              # exactly one new owner
    assert [d["job_id"] for d in l2] == [jid]
    assert l2[0]["attempt"] == 2
    assert client.lease("w1") == []
    assert client.progress(jid, "w1")["verdict"] == "lost"
    assert client.progress(jid, "w2", plugin_index=0)["verdict"] == "ok"
    # the stale owner's outcome is void: complete and upload are 409
    with pytest.raises(ServiceError) as ei:
        client.complete(jid, "w1", "done")
    assert ei.value.status == 409
    with pytest.raises(ServiceError) as ei:
        client.upload_result(jid, "w1", "recon", b"\x93NUMPY...")
    assert ei.value.status == 409


def test_unsafe_names_rejected(broker):
    """worker_id and result dataset names become path components on
    the broker — separators and dot-leading names are refused with
    400 before they reach the filesystem."""
    svc, client = broker
    for bad in ("../evil", "a/b", "/abs", ".."):
        with pytest.raises(ServiceError) as ei:
            client.register_worker(worker_id=bad)
        assert ei.value.status == 400
    client.register_worker(worker_id="w1")
    jid = client.submit(_spec(seed=3))
    assert client.lease("w1")
    for bad in ("../../etc/evil", "..", "a/b"):
        with pytest.raises(ServiceError) as ei:
            client.upload_result(jid, "w1", bad, b"x")
        assert ei.value.status == 400


def test_cancel_during_lease_yields_cancelled_verdict(broker):
    svc, client = broker
    client.register_worker(worker_id="w1")
    jid = client.submit(_spec(seed=2))
    assert client.lease("w1")
    assert client.progress(jid, "w1", plugin_index=0,
                           n_plugins=3)["verdict"] == "ok"
    out = client.cancel(jid)
    assert out["cancelled"] is True and out.get("pending") is True
    # the job is not terminal until the worker is told to stop...
    assert client.progress(jid, "w1",
                           plugin_index=1)["verdict"] == "cancelled"
    assert client.status(jid)["state"] == "cancelled"
    # ...and the lease is gone with it
    assert client.progress(jid, "w1")["verdict"] == "lost"
    with pytest.raises(ServiceError) as ei:
        client.complete(jid, "w1", "done")
    assert ei.value.status == 409


def test_requeued_job_leases_in_priority_order(broker):
    """An expired lease's job re-enters at the front of its priority
    class (oldest seq), ahead of later same-priority submissions."""
    svc, client = broker
    client.register_worker(worker_id="w1")
    j1 = client.submit(_spec(seed=1))
    assert [d["job_id"] for d in client.lease("w1")] == [j1]
    j2 = client.submit(_spec(seed=2))
    time.sleep(0.8)                      # j1's lease expires, requeued
    got = client.lease("w1", max_jobs=1)
    assert [d["job_id"] for d in got] == [j1], (got, j2)


# ============================================ capability filters & leases
def test_capability_filter_routes_jobs(broker):
    """plugins / mesh_shape capability filters decide which worker may
    lease which job."""
    svc, client = broker
    client.register_worker(worker_id="plain", plugins=PLAIN_CAPS)
    client.register_worker(worker_id="full")      # unrestricted
    jid = client.submit(_spec(seed=1, delay=0.01))   # needs slow_identity
    assert client.lease("plain") == []   # can't run slow_identity
    assert [d["job_id"] for d in client.lease("full")] == [jid]

    # device capacity: a job demanding 4 cards skips a 1-card worker
    client.register_worker(worker_id="small", mesh_shape=[1])
    client.register_worker(worker_id="big", mesh_shape=[4],
                           device="NVIDIA H100 80GB HBM3",
                           transport="cuda")
    jm = client.submit(_spec(seed=2), metadata={"mesh_shape": [4]})
    assert client.lease("small") == []
    assert [d["job_id"] for d in client.lease("big")] == [jm]
    big = client.workers()["big"]
    assert (big["device"], big["transport"], big["mesh_shape"]) == \
        ("NVIDIA H100 80GB HBM3", "cuda", [4])


def test_cuda_worker_advertises_one_card(monkeypatch):
    """A ``cuda`` worker computes on one card, so it registers
    ``mesh_shape [1]`` on a host with more (it advertised the host's
    card count, and could be leased a job asking for 4 cards)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    w = PipelineWorker("http://127.0.0.1:9", device="cuda")
    assert w.mesh_shape == [1]


def test_sharded_worker_takes_the_jobs_asking_for_its_slots():
    """``service.worker --transport sharded --slots 2`` (a process on 2
    CPU slots) registers ``mesh_shape [2]``; a job whose metadata asks
    for ``mesh_shape [2]`` is leased to it and never to a one-device
    worker, and its volume equals the single-process run bit for bit."""
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=5.0)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=60.0)
    one = PipelineWorker(url, device="cpu", worker_id="one", poll=0.01)
    one.register()
    workers = spawn_local_workers(url, 1, transport="sharded",
                                  device="cpu", slots=2, poll=0.05,
                                  worker_ids=["two"],
                                  pythonpath_extra=(TESTS_DIR,))
    try:
        deadline = time.time() + 60
        while "two" not in client.workers() and time.time() < deadline:
            time.sleep(0.1)
        regs = client.workers()
        assert (regs["one"]["mesh_shape"], regs["one"]["transport"]) == \
            ([1], "cuda")
        assert (regs["two"]["mesh_shape"], regs["two"]["transport"]) == \
            ([2], "sharded")
        spec = _spec(seed=5, n_det=16, n_angles=8)
        spec["plugins"][0]["params"]["n_rows"] = 2
        jid = client.submit(spec, metadata={"mesh_shape": [2]})
        assert one.run_once() is False
        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done" and snap["worker_id"] == "two", snap
        np.testing.assert_array_equal(client.result(jid), _reference(spec))
    finally:
        _reap(workers)
        svc.stop()


def test_capability_starvation_regression(broker):
    """An unmatchable high-priority head must not shadow matchable
    lower-priority jobs: the restricted worker keeps draining its
    matchable jobs in FIFO order while the head waits for a capable
    worker."""
    svc, client = broker
    client.register_worker(worker_id="plain", plugins=PLAIN_CAPS)
    client.register_worker(worker_id="full")
    j_slow = client.submit(_spec(seed=1, delay=0.01), priority=10)
    j_plain = [client.submit(_spec(seed=s)) for s in (2, 3, 4)]
    # the plain worker drains ITS jobs FIFO, never blocked by j_slow
    for expect in j_plain:
        got = client.lease("plain")
        assert [d["job_id"] for d in got] == [expect]
    assert client.lease("plain") == []   # only the unmatchable one left
    assert client.status(j_slow)["state"] == "queued"
    # the capable worker still sees priority order: j_slow first
    assert [d["job_id"] for d in client.lease("full")] == [j_slow]


def test_queue_predicate_pop_is_starvation_safe():
    """JobQueue.get(predicate=...) regression: scan past an unmatchable
    head without disturbing it, repeatedly."""
    q = JobQueue()
    pl = lambda **kw: from_spec(_spec(**kw), device="cpu")  # noqa: E731
    a = q.submit(pl(seed=0, delay=0.01), priority=5)
    b = q.submit(pl(seed=1), priority=0)
    c = q.submit(pl(seed=2), priority=0)
    caps = set(PLAIN_CAPS)
    pred = lambda j: chain_plugin_names(j.process_list) <= caps  # noqa: E731
    assert q.get(timeout=0, predicate=pred) is b   # skips head a, FIFO
    assert q.get(timeout=0, predicate=pred) is c
    assert q.get(timeout=0, predicate=pred) is None  # a never matched
    assert q.get(timeout=0) is a        # ...and kept its queue position
    # get_batch honours the predicate for head + gang members too
    d = q.submit(pl(seed=3))
    q.submit(pl(seed=3, delay=0.01))
    batch = q.get_batch(4, timeout=0, match=lambda x, y: True,
                        predicate=pred)
    assert batch == [d]                 # e filtered out of the gang


def test_batch_lease_renews_pending_mates(broker):
    """A worker leasing max_batch jobs on a transport that does not
    gang runs them sequentially; the heartbeat must renew the WAITING
    jobs' leases too (ttl here is 0.4s, under each job's 0.4 s of
    per-frame delays), so none are requeued."""
    svc, client = broker
    ids = [client.submit(_spec(seed=s, delay=0.05)) for s in range(3)]
    w = PipelineWorker(client.base_url, device="cpu", worker_id="batch-w",
                       max_batch=3, poll=0.01, heartbeat=0.1,
                       transport_factory=lambda d: InMemoryTransport("cpu"),
                       transport="inmemory")
    w.register()
    assert w.run_once() is True
    assert [client.status(j)["state"] for j in ids] == ["done"] * 3
    st = client.stats()
    assert st["jobs_requeued"] == 0 and st["leases_expired"] == 0
    for i, j in enumerate(ids):
        np.testing.assert_array_equal(
            client.result(j),
            _reference(_spec(seed=i, delay=0.05), InMemoryTransport))


def test_queue_predicate_scan_reaps_cancelled_tombstones():
    """Broker-mode pops always pass a predicate; cancelled jobs' heap
    entries must be reaped by the scan, not linger forever."""
    q = JobQueue()
    a = q.submit(from_spec(_spec(seed=0), device="cpu"))
    b = q.submit(from_spec(_spec(seed=1), device="cpu"))
    assert q.cancel(a.job_id) is True
    assert q.get(timeout=0, predicate=lambda j: True) is b
    assert q._heap == []                # tombstone reaped with the pop


def test_shared_fs_results_and_outside_paths_refused(broker):
    """Shared-fs hand-off works end-to-end, and a complete() naming a
    path OUTSIDE the broker results_dir is refused."""
    svc, client = broker
    spec = _spec(seed=8)
    jid = client.submit(spec)
    w = PipelineWorker(client.base_url, device="cpu", worker_id="fs-w",
                       poll=0.01, shared_fs=True)
    w.register()
    assert w.results_dir == svc.broker.results_dir
    assert w.run_once() is True
    np.testing.assert_array_equal(client.result(jid), _reference(spec))

    j2 = client.submit(_spec(seed=9))
    # acting on fs-w's behalf needs fs-w's minted secret
    client.adopt_worker_secret("fs-w", w.client.worker_secret("fs-w"))
    assert client.lease("fs-w")
    with pytest.raises(ServiceError) as ei:
        client.complete(j2, "fs-w", "done",
                        results={"recon": {"path": "/etc/hostname"}})
    assert ei.value.status == 400


class _Bias(BaseFilter):
    """Adds a per-job bias, a data param: gang members' constants differ
    and the plugin has no gang hook, so they share no built step."""

    name = "bias_per_job"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"bias": 0.0}
    data_params = ("bias",)

    def setup(self, in_datasets):
        self._bias = float(self.params["bias"])
        return super().setup(in_datasets)

    def process_frames(self, frames):
        return frames[0] + self._bias


def test_gang_mismatch_marks_each_members_trace(broker):
    """Two leased jobs of one chain signature whose bias differs share no
    built step for it: the worker's gang runs that step member by
    member, counts one fallback, and marks each member's trace with one
    ``gang.fallback`` span naming the plugin and the gang's size; every
    ``process`` span keeps the gang's size, and each result equals its
    solo run."""
    wire.register_plugin(_Bias)
    svc, client = broker
    specs = []
    for bias in (0.5, 1.5):
        spec = _spec(seed=3)
        spec["plugins"].insert(2, {
            "plugin": "bias_per_job", "params": {"bias": bias},
            "in_datasets": ["tomo"], "out_datasets": ["tomo"]})
        specs.append(spec)
    ids = [client.submit(s) for s in specs]
    w = PipelineWorker(client.base_url, device="cpu", worker_id="gang-w",
                       max_batch=2, poll=0.01, heartbeat=0.1)
    w.register()
    assert w.run_once() is True
    assert w.gang_fallbacks == 1
    for jid, spec in zip(ids, specs):
        assert client.status(jid)["state"] == "done"
        np.testing.assert_allclose(client.result(jid), _reference(spec),
                                   **TOL)
        spans = client.trace(jid)["spans"]
        (fell,) = [s for s in spans if s["name"] == "gang.fallback"]
        assert (fell["attrs"]["plugin"], fell["attrs"]["gang"]) == \
            ("bias_per_job", 2)
        assert "differ" in fell["attrs"]["reason"]
        assert {s["attrs"].get("gang") for s in spans
                if s.get("attrs", {}).get("phase") == "process"} == {2}


# ====================================================== in-process worker
def test_inprocess_worker_round_trip(broker):
    """PipelineWorker as a library (no subprocess): register, lease,
    run, upload; the broker serves the result and per-worker stats."""
    svc, client = broker
    spec = _spec(seed=7)
    jid = client.submit(spec)
    w = PipelineWorker(client.base_url, device="cpu", worker_id="lib-w",
                       poll=0.01)
    w.register()
    assert w.run_once() is True
    snap = client.status(jid)
    assert snap["state"] == "done" and snap["worker_id"] == "lib-w"
    np.testing.assert_array_equal(client.result(jid), _reference(spec))
    workers = client.workers()
    assert workers["lib-w"]["jobs_done"] == 1
    assert (workers["lib-w"]["device"], workers["lib-w"]["transport"]) \
        == ("cpu", "cuda")
    assert client.stats()["jobs_done"] == 1


# ============================================================ JAX parity
def test_worker_process_matches_jax_runner(tmp_path):
    """One spec through the port's broker and a worker subprocess: the
    JAX package's ``PluginRunner`` volume within the chain's bound."""
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=5.0)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    client = PipelineClient(url, timeout=60.0)
    workers = _spawn(url, 1, poll=0.05, worker_ids=["w0"])
    try:
        spec = _spec(seed=11, n_det=20, n_angles=16)
        jid = client.submit(spec)
        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done" and snap["worker_id"] == "w0", snap
        got = client.result(jid)
        np.testing.assert_allclose(got, _jax_reference(spec), **TOL)
        np.testing.assert_array_equal(got, _reference(spec))
    finally:
        _reap(workers)
        svc.stop()


def test_port_worker_serves_the_jax_broker():
    """The port's ``PipelineWorker.run_once`` against the JAX package's
    broker-mode service: it registers, leases, runs on the CPU, uploads
    and completes over the JAX broker's protocol."""
    svc = JS.PipelineService(workers_remote=True, lease_ttl=30.0)
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    jax_client = JS.PipelineClient(url, timeout=60.0)
    try:
        spec = _spec(seed=12)
        jid = jax_client.submit(spec)
        w = PipelineWorker(url, device="cpu", worker_id="torch-w",
                           poll=0.01)
        assert w.register() == "torch-w"
        assert w.run_once() is True
        snap = jax_client.wait(jid, timeout=60)
        assert snap["state"] == "done" and snap["worker_id"] == "torch-w"
        np.testing.assert_allclose(jax_client.result(jid),
                                   _jax_reference(spec), **TOL)
        assert jax_client.workers()["torch-w"]["jobs_done"] == 1
    finally:
        svc.stop()


def test_jax_worker_serves_the_port_broker(broker):
    """The JAX package's ``PipelineWorker.run_once`` against the port's
    broker: the port serves the JAX worker's upload as the result."""
    svc, client = broker
    svc.broker.lease_ttl = 30.0
    spec = _spec(seed=13)
    jid = client.submit(spec)
    w = JS.PipelineWorker(client.base_url, worker_id="jax-w", poll=0.01)
    w.register()
    assert w.run_once() is True
    snap = client.wait(jid, timeout=60)
    assert snap["state"] == "done" and snap["worker_id"] == "jax-w"
    np.testing.assert_allclose(client.result(jid), _reference(spec), **TOL)
    cluster = {w["worker_id"]: w for w in client.cluster()["workers"]}
    assert cluster["jax-w"]["device"] is None       # the JAX worker
    assert cluster["jax-w"]["jobs_done"] == 1
