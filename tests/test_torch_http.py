"""The port's HTTP front end (``repro_torch.service.server``) against
tests/test_http_service.py and the HTTP cases of tests/test_streaming.py,
on ``CudaTransport("cpu")`` at 20 x 20 chains.

Every case that computes a volume also runs the JAX package on the same
spec and seed and agrees with it within the chain's bound (rtol 1e-3,
atol 1e-4); the error contract is held against the JAX package's own
service in local mode (the same status codes and JSON fields).  Every
server is stopped in ``finally``; every wait has a timeout.
"""
import contextlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.core as R
import repro.service as JS

from repro_torch.core import ChunkedFileTransport, CudaTransport, PluginRunner
from repro_torch.service import (CheckpointStore, PipelineClient,
                                 PipelineService, ServiceError, from_spec,
                                 to_spec)
from repro_torch.service import server as port_server
from repro_torch.tomo import standard_chain

N = dict(n_det=20, n_angles=20, n_rows=1)
TOL = dict(rtol=1e-3, atol=1e-4)
WAIT_S = 120


def _chain(seed=0, **over):
    return standard_chain(**{**N, **over}, seed=seed, device="cpu")


def _port_recon(spec) -> np.ndarray:
    """A serial run of the spec on the port's CPU transport."""
    r = PluginRunner(from_spec(spec, device="cpu"), CudaTransport("cpu"))
    return r.transport.read(r.run()["recon"])


def _jax_recon(spec) -> np.ndarray:
    """The JAX package's serial run of the same spec (its loader
    simulates the same seed)."""
    r = R.PluginRunner(JS.from_spec(spec), R.InMemoryTransport())
    return np.asarray(r.transport.read(r.run()["recon"]))


@contextlib.contextmanager
def _served(jax=False, start=True, **kw):
    """A served service (the port's on the CPU, or the JAX package's)
    and a client for it; with ``start=False`` the scheduler's workers are
    stopped, so submitted jobs stay queued."""
    svc = (JS.PipelineService(**kw) if jax
           else PipelineService(device="cpu", **kw))
    host, port = svc.serve(port=0)
    if not start:
        svc.scheduler.shutdown()
    try:
        yield svc, PipelineClient(f"http://{host}:{port}", timeout=30.0)
    finally:
        svc.stop()


@pytest.fixture
def service():
    with _served(n_workers=2) as pair:
        yield pair


# ------------------------------------------------------------- end-to-end
def test_end_to_end_submit_poll_result(service):
    svc, client = service
    seeds_prios = [(0, 5), (1, 0), (2, 2)]
    ids = [client.submit(_chain(seed=s), priority=p, metadata={"seed": s})
           for s, p in seeds_prios]
    for (seed, prio), jid in zip(seeds_prios, ids):
        snap = client.wait(jid, timeout=WAIT_S)
        assert snap["state"] == "done", snap
        assert snap["priority"] == prio
        assert snap["metadata"]["seed"] == seed
        assert snap["plugin_index"] == snap["n_plugins"] > 0
        got = client.result(jid)
        spec = to_spec(_chain(seed=seed))
        # a serial run on the same transport type: bit-identical
        np.testing.assert_array_equal(got, _port_recon(spec))
        np.testing.assert_allclose(got, _jax_recon(spec), **TOL)
    # identical resubmission: no new builds, hits visible in /stats
    before = client.stats()["compile_cache"]
    jid = client.submit(_chain(seed=9))
    assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
    after = client.stats()["compile_cache"]
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    assert client.stats()["jobs_done"] == 4


def test_result_streams_from_chunked_files(tmp_path):
    with _served(n_workers=1, transport_factory=lambda job:
                 ChunkedFileTransport(str(tmp_path / job.job_id),
                                      device="cpu")) as (_, client):
        jid = client.submit(_chain(seed=3))
        assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
        got = client.result(jid, dataset="recon")
        spec = to_spec(_chain(seed=3))
        np.testing.assert_allclose(got, _port_recon(spec), **TOL)
        np.testing.assert_allclose(got, _jax_recon(spec), **TOL)


def test_result_streamed_in_row_blocks(service, monkeypatch):
    """A result leaves the transport one block of rows at a time (one
    device-to-host copy each on the card) and arrives whole."""
    svc, client = service
    monkeypatch.setattr(port_server, "RESULT_BLOCK_BYTES", 300)
    jid = client.submit(_chain(seed=5, n_rows=3))
    assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
    ds, _ = svc.result_dataset(jid)
    blocks = list(port_server._blocks(ds.backing))
    assert len(blocks) == 3                  # one 20 x 20 slice a block
    got = client.result(jid)
    assert got.shape == (3, 20, 20)
    np.testing.assert_array_equal(got, ds.backing.numpy())


# ----------------------------------------------------------- error paths
def test_admission_rejection_is_429():
    for jax in (False, True):
        with _served(jax=jax, start=False, n_workers=1,
                     max_pending=1) as (_, client):
            client.submit(_chain())
            with pytest.raises(ServiceError) as ei:
                client.submit(_chain(seed=1))
            assert ei.value.status == 429
            assert "max_pending" in ei.value.message


def test_unknown_plugin_spec_is_400(service):
    _, client = service
    with pytest.raises(ServiceError) as ei:
        client.submit({"plugins": [{"plugin": "warp_drive"}]})
    assert ei.value.status == 400
    assert "warp_drive" in ei.value.message


def test_structurally_broken_chain_is_400(service):
    _, client = service
    spec = {"plugins": [{"plugin": "synthetic_tomo_loader",
                         "params": {"n_det": 16},
                         "out_datasets": ["tomo"]}]}   # no saver
    with pytest.raises(ServiceError) as ei:
        client.submit(spec)
    assert ei.value.status == 400
    assert "saver" in ei.value.message


def test_malformed_json_body_is_400(service):
    _, client = service
    req = urllib.request.Request(
        client.base_url + "/jobs", data=b"{not json",
        method="POST", headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    assert "JSON" in json.loads(ei.value.read())["error"]


def test_unknown_job_is_404(service):
    _, client = service
    for call in (lambda: client.status("ghost"),
                 lambda: client.result("ghost"),
                 lambda: client.cancel("ghost"),
                 lambda: client.trace("ghost")):
        with pytest.raises(ServiceError) as ei:
            call()
        assert ei.value.status == 404


def test_duplicate_active_job_id_is_409():
    with _served(start=False, n_workers=1) as (_, client):
        client.submit(_chain(), job_id="twin")
        with pytest.raises(ServiceError) as ei:
            client.submit(_chain(seed=1), job_id="twin")
        assert ei.value.status == 409


def test_result_before_done_is_409():
    with _served(start=False, n_workers=1) as (_, client):
        jid = client.submit(_chain())
        with pytest.raises(ServiceError) as ei:
            client.result(jid)
        assert ei.value.status == 409


def test_cancel_queued_job_via_http():
    replies = []
    for jax in (False, True):
        with _served(jax=jax, start=False, n_workers=1) as (_, client):
            jid = client.submit(_chain(), job_id="c1")
            out = client.cancel(jid)
            assert out["cancelled"] is True
            assert client.status(jid)["state"] == "cancelled"
            with pytest.raises(ServiceError) as ei:
                client.cancel(jid)
            assert ei.value.status == 409
            replies.append(out)
    assert replies[0] == replies[1]          # the same JSON reply


def test_job_ids_with_url_unsafe_characters():
    with _served(start=False, n_workers=1) as (_, client):
        jid = "scan 1/#7"
        assert client.submit(_chain(), job_id=jid) == jid
        assert client.status(jid)["job_id"] == jid
        assert client.cancel(jid)["cancelled"] is True


def test_resumed_from_surfaces_over_http(tmp_path):
    """A killed job's checkpoint + a resubmission under the same id: the
    snapshot reports resumed_from > 0 and the volume is the serial
    run's."""
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(_chain(seed=7), CudaTransport("cpu"))
    r.prepare()
    r.step()
    store.save("scan-x", r)
    with _served(n_workers=1, checkpoints=store) as (_, client):
        jid = client.submit(_chain(seed=7), job_id="scan-x")
        snap = client.wait(jid, timeout=WAIT_S)
        assert snap["state"] == "done", snap
        assert snap["resumed_from"] == 1
        spec = to_spec(_chain(seed=7))
        np.testing.assert_allclose(client.result(jid), _port_recon(spec),
                                   **TOL)
        np.testing.assert_allclose(client.result(jid), _jax_recon(spec),
                                   **TOL)


# ------------------------------------------------------------- discovery
def test_healthz_jobs_and_plugins(service):
    _, client = service
    assert client.health()["ok"] is True
    jid = client.submit(_chain())
    client.wait(jid, timeout=WAIT_S)
    assert any(j["job_id"] == jid for j in client.jobs())
    reg = client.plugins()
    assert "fbp_recon" in reg
    assert reg["synthetic_tomo_loader"]["params"]["seed"]["data_param"]
    # the JAX package's default registry (its tomo plugins; tests may
    # register more in either package's process-wide registry)
    assert set(reg) >= {n for n, c in JS.registered_plugins().items()
                        if c.__module__ == "repro.tomo.plugins"}


def test_spec_submission_equals_processlist_submission(service):
    _, client = service
    spec = to_spec(_chain(seed=4))
    j1 = client.submit(spec)
    j2 = client.submit(_chain(seed=4))
    s1, s2 = (client.wait(j, timeout=WAIT_S) for j in (j1, j2))
    assert s1["state"] == s2["state"] == "done"
    np.testing.assert_array_equal(client.result(j1), client.result(j2))
    np.testing.assert_allclose(client.result(j1), _jax_recon(spec), **TOL)


def test_job_snapshot_has_the_jax_services_fields():
    fields = []
    for jax in (False, True):
        with _served(jax=jax, n_workers=1) as (_, client):
            jid = client.submit(_chain(seed=2))
            snap = client.wait(jid, timeout=WAIT_S)
            assert snap["state"] == "done", snap
            # the port counts gang fallbacks, which the JAX package has not
            fields.append((set(snap), set(client.stats())
                           - {"wall", "gang_fallbacks"},
                           set(client.trace(jid))))
    assert fields[0] == fields[1]


def test_cross_service_spec_gives_the_same_volume():
    """One spec JSON (written by the port, so without the loader's
    device), submitted over HTTP to the JAX package's service and to the
    port's, gives the same volume."""
    spec = json.loads(json.dumps(to_spec(_chain(seed=11))))
    vols = []
    for jax in (False, True):
        with _served(jax=jax, n_workers=1) as (_, client):
            jid = client.submit(spec)
            assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
            vols.append(client.result(jid))
    np.testing.assert_allclose(vols[0], vols[1], **TOL)


# ------------------------------------------------------- local-mode only
def test_worker_routes_answer_409_as_the_jax_local_mode():
    calls = [("GET", "/cluster", None), ("GET", "/workers", None),
             ("GET", "/executables", None),
             ("GET", "/executables/" + "ab" * 16, None),
             ("POST", "/workers", {}), ("POST", "/jobs/lease",
                                        {"worker_id": "w"}),
             ("POST", "/jobs/j/progress", {"worker_id": "w"}),
             ("POST", "/jobs/j/complete", {"worker_id": "w"}),
             ("PUT", "/jobs/j/result?dataset=recon", b"x"),
             ("PUT", "/executables/" + "ab" * 16, b"x")]
    answers = []
    for jax in (False, True):
        with _served(jax=jax, n_workers=1) as (_, client):
            got = []
            for method, path, body in calls:
                data = (body if isinstance(body, bytes)
                        else None if body is None
                        else json.dumps(body).encode())
                req = urllib.request.Request(client.base_url + path,
                                             data=data, method=method)
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=10)
                got.append((ei.value.code,
                            "broker mode" in json.loads(
                                ei.value.read())["error"]))
            answers.append(got)
    assert answers[0] == answers[1] == [(409, True)] * len(calls)


def test_broker_mode_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="D1 part two"):
        PipelineService(device="cpu", workers_remote=True)


def test_trace_formats_and_cost_profile():
    """JSON, text and OTLP traces of one job; with cost analysis every
    kernel step's process span carries its kernel's counts."""
    with _served(n_workers=1, cost_analysis=True) as (svc, client):
        jid = client.submit(_chain(seed=1))
        assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
        doc = client.trace(jid)
        otlp = client.trace(jid, otlp=True)
        n_otlp = sum(len(ss["spans"]) for rs in otlp["resourceSpans"]
                     for ss in rs["scopeSpans"])
        assert n_otlp == len(doc["spans"]) > 0
        assert "plugin.fbp_recon.process" in client.trace(jid, text=True)
        process = {s["name"]: s["attrs"] for s in doc["spans"]
                   if s["name"].endswith(".process")}
        # on the CPU the steps take the kernels' plain versions: the same
        # work is counted, no kernel is launched
        from repro_torch.kernels.correction.kernel import cost
        want = cost(20, 20, 2)
        got = process["plugin.dark_flat_correction.process"]
        assert (got["flops"], got["bytes_accessed"]) == (
            want["flops"], want["bytes"])
        assert all("flops" in a and "bytes_accessed" in a
                   for a in process.values())
        assert not any(k.startswith("launches.") for a in process.values()
                       for k in a)
        assert "jobs_completed 1" in client.metrics()
        assert client.slo()["critical_firing"] == []
        assert client.health(ready=True)["ready"] is True


def _process_attrs(client, jid) -> dict:
    return {s["name"]: s["attrs"] for s in client.trace(jid)["spans"]
            if s["name"].endswith(".process")}


def test_cost_measured_once_per_step_across_jobs(monkeypatch):
    """The cost profiles live in the service's compile cache: a second
    job of the chain measures no step again (each of its steps runs
    once, not twice), and its spans carry the same costs."""
    calls = []
    measure = CudaTransport._measure

    def counting(self, plugins, all_consts):
        calls.append(plugins[0].name)
        return measure(self, plugins, all_consts)

    monkeypatch.setattr(CudaTransport, "_measure", counting)
    costs = ("flops", "bytes_accessed", "peak_memory")
    with _served(n_workers=1, cost_analysis=True) as (svc, client):
        first = client.submit(_chain(seed=1))
        assert client.wait(first, timeout=WAIT_S)["state"] == "done"
        measured = list(calls)
        second = client.submit(_chain(seed=2))
        assert client.wait(second, timeout=WAIT_S)["state"] == "done"
        a, b = _process_attrs(client, first), _process_attrs(client, second)
    assert calls == measured and len(measured) == len(a) > 0
    assert {n: [x[k] for k in costs] for n, x in a.items()} == \
        {n: [x[k] for k in costs] for n, x in b.items()}


def test_peak_memory_is_the_steps_own_with_two_workers():
    """``peak_memory`` counts what the step's own ops allocate: two
    workers costing two chains read what one worker reads for each."""
    def peaks(n_workers):
        with _served(n_workers=n_workers, cost_analysis=True) as (_, c):
            ids = [c.submit(_chain(n_det=nd, n_angles=nd))
                   for nd in (20, 28)]
            for jid in ids:
                assert c.wait(jid, timeout=WAIT_S)["state"] == "done"
            return [{n: x["peak_memory"] for n, x in
                     _process_attrs(c, jid).items()} for jid in ids]
    one = peaks(1)
    assert peaks(2) == one
    # at least the correction's float32 output
    assert one[0]["plugin.dark_flat_correction.process"] >= 20 * 20 * 4
    assert all(one[k][f"plugin.{p}.process"] > 0 for k in (0, 1)
               for p in ("dark_flat_correction", "sinogram_filter",
                         "fbp_recon"))


def test_peak_memory_reads_only_its_own_thread():
    """What another thread allocates while a step is measured stays out
    of the step's reading (dispatch modes are per thread)."""
    import threading
    from repro_torch.core.transport import _PeakMemory
    started, allocated = threading.Event(), threading.Event()
    held = []

    def other():
        started.wait(10)
        held.append(torch.ones(1 << 20))           # 4 MB meanwhile
        allocated.set()

    th = threading.Thread(target=other)
    th.start()
    x = torch.ones(1024)
    with _PeakMemory(torch.device("cpu")) as mem:
        started.set()
        assert allocated.wait(10)
        y = x * 2                                  # 4 kB of its own
        z = y.view(32, 32)                         # a view: no new bytes
        del y, z
        w = x + 1                                  # y freed: still 4 kB
    th.join(10)
    assert mem.peak == 1024 * 4
    del w, held


# ============================================ streaming over HTTP
def _stream_spec(seed=0, streaming=True):
    """A small loader -> correction -> FBP -> saver chain (the JAX
    package's streaming tests' chain)."""
    plugins = [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": 16, "n_angles": 24, "n_rows": 1,
                    "seed": seed},
         "out_datasets": ["tomo"]},
        {"plugin": "dark_flat_correction", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]
    spec = {"version": 1, "plugins": plugins}
    if streaming:
        spec = {**spec, "version": 2, "streaming": True}
    return spec


def _batch(spec):
    return {**{k: v for k, v in spec.items() if k != "streaming"},
            "version": 1}


def _frames(spec) -> np.ndarray:
    """What the chain's loader would produce on the CPU."""
    e = from_spec(spec, device="cpu").entries[0]
    loader = e.cls(**e.params, in_datasets=list(e.in_datasets),
                   out_datasets=list(e.out_datasets))
    return np.asarray(loader.load()[0].materialise())


def test_http_streamed_job_bit_identical_with_preview():
    """A job streamed over HTTP chunk by chunk finishes bit-identical to
    the batch run, and ``GET /jobs/{id}/preview`` serves a partial
    reconstruction BEFORE EOF."""
    import time
    spec = _stream_spec(seed=21)
    want = _port_recon(_batch(spec))
    frames = _frames(spec)
    with _served(n_workers=1) as (_, client):
        jid = client.submit(spec)
        preview = None
        for lo in range(0, frames.shape[0], 7):
            out = client.ingest(jid, frames[lo:lo + 7], lo)
            assert out["watermark"] == min(lo + 7, frames.shape[0])
            if lo >= 14 and preview is None:
                deadline = time.time() + WAIT_S
                while preview is None and time.time() < deadline:
                    try:
                        preview = client.preview(jid)
                    except ServiceError as e:
                        assert e.status == 409, e
                        time.sleep(0.05)
        assert preview is not None, "no preview before EOF"
        arr, cut = preview
        assert arr.shape == want.shape and 0 < cut <= frames.shape[0]
        client.eof(jid)
        snap = client.wait(jid, timeout=WAIT_S)
        assert snap["state"] == "done", snap
        assert snap["streaming"] is True
        assert snap["frames_consumed"] == frames.shape[0]
        got = client.result(jid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _jax_recon(_batch(spec)), **TOL)


def test_peak_memory_leaves_out_the_cost_count():
    """What an op allocates to count its kernel's work (the
    backprojection's rays on the detector) is no part of the step's
    peak."""
    from repro_torch.core.transport import _PeakMemory
    from repro_torch.kernels import tally

    def count():
        return {"flops": float((torch.ones(1 << 20) > 0).sum()),
                "bytes": 0.0}

    x = torch.ones(1024)
    with tally.tally(costs=True) as t, \
            _PeakMemory(torch.device("cpu")) as mem:
        y = x * 2
        tally.note("k", count)
    assert t.flops == 1 << 20
    assert mem.peak == 1024 * 4
    del y


def test_client_ingest_synthetic_feeds_a_streaming_job(capsys):
    """``client submit --streaming`` then ``client ingest --synthetic``
    (simulated where ``--device`` says, fed chunk by chunk from the
    host): the job ends bit for bit its batch run."""
    from repro_torch.launch import pipeline_serve
    geo = ["--n-det", "16", "--n-angles", "24", "--n-rows", "1",
           "--seed", "5"]
    with _served(n_workers=1) as (_, client):
        url = ["client", "--url", client.base_url]
        pipeline_serve.main(url + ["submit", "--demo-chain", "--streaming",
                                   "--job-id", "scan5"] + geo)
        pipeline_serve.main(url + ["ingest", "scan5", "--synthetic",
                                   "--device", "cpu", "--chunk", "7"] + geo)
        assert client.wait("scan5", timeout=WAIT_S)["state"] == "done"
        got = client.result("scan5")
    out = capsys.readouterr().out
    assert out.count("fed frames") == 4 and "watermark 24" in out
    spec = to_spec(standard_chain(n_det=16, n_angles=24, n_rows=1, seed=5,
                                  device="cpu"))
    np.testing.assert_array_equal(got, _port_recon(spec))
    np.testing.assert_allclose(got, _jax_recon(spec), **TOL)


def test_http_ingest_contract_409s():
    spec = _stream_spec(seed=3)
    frames = _frames(spec)
    with _served(n_workers=1) as (_, client):
        jid = client.submit(spec)
        client.ingest(jid, frames[:6], 0)
        for chunk, start in ((frames[:6], 0), (frames[8:12], 8)):
            with pytest.raises(ServiceError) as ei:   # duplicate, gap
                client.ingest(jid, chunk, start)
            assert ei.value.status == 409
        with pytest.raises(ServiceError) as ei:
            client.ingest("nope", frames[:1], 0)
        assert ei.value.status == 404
        plain = client.submit(_stream_spec(seed=4, streaming=False))
        with pytest.raises(ServiceError) as ei:
            client.ingest(plain, frames[:1], 0)
        assert ei.value.status == 409
        client.ingest(jid, frames[6:], 6)
        client.eof(jid)
        with pytest.raises(ServiceError) as ei:
            client.ingest(jid, frames[:1], frames.shape[0])
        assert ei.value.status == 409
        assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
        assert client.eof(jid)["eof"] is True
        j2 = client.submit(_stream_spec(seed=6))
        client.eof(j2)
        with pytest.raises(ServiceError) as ei:
            client.eof(j2)
        assert ei.value.status == 409
        assert client.wait(j2, timeout=WAIT_S)["state"] == "failed"


def test_token_guards_mutating_endpoints():
    spec = _stream_spec(seed=5)
    frames = _frames(spec)
    with _served(n_workers=1, token="s3cret") as (_, anon):
        authed = PipelineClient(anon.base_url, timeout=60.0,
                                token="s3cret")
        with pytest.raises(ServiceError) as ei:
            anon.submit(spec)
        assert ei.value.status == 401
        jid = authed.submit(spec)
        for call in (lambda: anon.ingest(jid, frames[:4], 0),
                     lambda: anon.eof(jid),
                     lambda: PipelineClient(anon.base_url, token="wrong")
                     .ingest(jid, frames[:4], 0)):
            with pytest.raises(ServiceError) as ei:
                call()
            assert ei.value.status == 401
        assert anon.status(jid)["state"]
        authed.ingest(jid, frames, 0)
        authed.eof(jid)
        snap = authed.wait(jid, timeout=WAIT_S)
        assert snap["state"] == "done", snap
        np.testing.assert_array_equal(anon.result(jid),
                                      _port_recon(_batch(spec)))


def test_trace_survives_history_eviction(tmp_path):
    with _served(n_workers=1, max_history=1,
                 trace_spool=str(tmp_path / "spool")) as (_, client):
        j1 = client.submit(_stream_spec(seed=1, streaming=False))
        client.wait(j1, timeout=WAIT_S)
        j2 = client.submit(_stream_spec(seed=2, streaming=False))
        client.wait(j2, timeout=WAIT_S)
        client.wait(client.submit(_stream_spec(seed=3, streaming=False)),
                    timeout=WAIT_S)
        with pytest.raises(ServiceError) as ei:
            client.status(j1)
        assert ei.value.status == 404
        tr = client.trace(j1)
        assert tr["job_id"] == j1 and tr["spans"]
        assert "(no spans)" not in client.trace(j1, text=True)
        otlp = client.trace(j1, otlp=True)
        assert sum(len(ss["spans"]) for rs in otlp["resourceSpans"]
                   for ss in rs["scopeSpans"]) == len(tr["spans"])
