"""Streaming acquisition in the port against tests/test_streaming.py:
a runner fed random-size slabs through ``enable_streaming``/``feed``/
``pump`` gives the batch run's reconstruction bit for bit, with a
preview mid-stream; bad feeds are rejected with the same messages;
``run()`` closes the transport on failure.  Plus: the port's streamed
chain and preview against the JAX package's on the same slabs, a
checkpoint mid-stream resumed by a fresh scheduler bit for bit, a
streaming job driven by ``PipelineScheduler`` from a stream another
thread fills, and the broker cases: a starved stream parks its lease, a
worker's pump latency and preview reach the broker, and a worker process
SIGKILLed mid-pump is resumed from its watermark by the survivor."""
import importlib
import os
import signal
import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro.service as JS
import repro.tomo as JT

from repro_torch.core import (ChunkedFileTransport, CudaTransport,
                              PluginRunner)
from repro_torch.core.patterns import PROJECTION
from repro_torch.core.plugin import BaseFilter
from repro_torch.core.process_list import ProcessList
from repro_torch.service import (CheckpointStore, JobQueue, JobState,
                                 PipelineClient, PipelineScheduler,
                                 PipelineService, PipelineWorker,
                                 from_spec, wire)
from repro_torch.service.worker import spawn_local_workers
from repro_torch.tomo.plugins import HDF5LikeSaver, SyntheticTomoLoader

#: the chain bound (tests/test_tomo_pipeline.py)
CHAIN_TOL = {"rtol": 1e-3, "atol": 1e-4}
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _spec(seed=0, n_det=16, n_angles=24, n_rows=1, streaming=True,
          device="cpu"):
    """A small loader → window (correction) → barrier (FBP) → saver
    chain, as the JAX package's streaming tests build it; ``device``
    None leaves the loader's parameter out (the JAX package's form)."""
    loader = {"n_det": n_det, "n_angles": n_angles, "n_rows": n_rows,
              "seed": seed}
    if device is not None:
        loader["device"] = device
    plugins = [
        {"plugin": "synthetic_tomo_loader", "params": loader,
         "out_datasets": ["tomo"]},
        {"plugin": "dark_flat_correction", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "ring_removal",
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]
    spec = {"version": 1, "plugins": plugins}
    if streaming:
        spec = {**spec, "version": 2, "streaming": True}
    return spec


def _slow_spec(seed, delay, **kw):
    """:func:`_spec` with ``slow_identity`` after the correction, a
    windowed step that sleeps ``delay`` per pumped slab."""
    spec = _spec(seed=seed, **kw)
    spec["plugins"].insert(2, {"plugin": "slow_identity",
                               "params": {"delay": delay},
                               "in_datasets": ["tomo"],
                               "out_datasets": ["tomo"]})
    return spec


def _runner(spec):
    return PluginRunner(from_spec(spec), CudaTransport("cpu"))


def _reference(spec) -> np.ndarray:
    batch = {k: v for k, v in spec.items() if k != "streaming"}
    ref = _runner({**batch, "version": 1})
    return ref.transport.read(ref.run()["recon"])


def _frames(spec) -> np.ndarray:
    """What the chain's loader WOULD produce — the frame stack an
    acquisition source streams in."""
    e = from_spec(spec).entries[0]
    loader = e.cls(**e.params, in_datasets=list(e.in_datasets),
                   out_datasets=list(e.out_datasets))
    return np.asarray(loader.load()[0].materialise())


def _slabs(n, lo=1, hi=6):
    """Random slab bounds covering [0, n), from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    out, at = [], 0
    while at < n:
        k = int(rng.integers(lo, hi))
        out.append((at, min(n, at + k)))
        at += k
    return out


# ======================================================== framework layer
def test_pump_matches_batch_random_chunks():
    spec = _spec(seed=11)
    want = _reference(spec)
    frames = _frames(spec)
    runner = _runner(spec)
    runner.enable_streaming()
    previewed = None
    for lo, hi in _slabs(frames.shape[0]):
        assert runner.feed(frames[lo:hi], lo) == hi
        runner.pump()
        if previewed is None and hi >= frames.shape[0] // 2:
            arr, cut = runner.preview()
            assert 0 < cut <= hi
            assert arr.shape == want.shape
            previewed = cut
    runner.mark_eof()
    runner.pump()
    assert runner.current_step == runner.n_steps
    runner.finalise()
    got = runner.transport.read(runner.datasets["recon"])
    np.testing.assert_array_equal(got, want)
    assert previewed is not None
    # once the chain has completed, the preview is the result
    arr, cut = runner.preview()
    assert cut == frames.shape[0]
    np.testing.assert_array_equal(arr, want)


def test_feed_rejects_out_of_order_and_overrun():
    spec = _spec(seed=1)
    frames = _frames(spec)
    runner = _runner(spec)
    runner.enable_streaming()
    assert runner.feed(frames[:4], 0) == 4
    with pytest.raises(ValueError, match="out of order"):
        runner.feed(frames[4:8], 6)      # gap
    with pytest.raises(ValueError, match="out of order"):
        runner.feed(frames[0:4], 0)      # duplicate
    with pytest.raises(ValueError):
        runner.mark_eof()                # premature: 4/24 frames
    with pytest.raises(ValueError, match="overruns"):
        runner.feed(np.concatenate([frames[4:], frames[:1]]), 4)
    with pytest.raises(RuntimeError, match="finalise at step 0"):
        runner.finalise()
    runner.feed(frames[4:], 4)
    runner.mark_eof()
    with pytest.raises(ValueError, match="after eof"):
        runner.feed(frames[:1], 24)


def test_run_failure_closes_transport(tmp_path):
    class _Boom(BaseFilter):
        name = "boom_filter"
        pattern_name = PROJECTION
        parameters = {}

        def process_frames(self, frames):
            raise RuntimeError("boom")

    class _SpyTransport(ChunkedFileTransport):
        closed = False

        def close(self):
            self.closed = True
            super().close()

    pl = (ProcessList()
          .add(SyntheticTomoLoader,
               params={"n_det": 16, "n_angles": 8, "n_rows": 1,
                       "device": "cpu"},
               out_datasets=["tomo"])
          .add(_Boom, in_datasets=["tomo"], out_datasets=["tomo"])
          .add(HDF5LikeSaver, in_datasets=["tomo"]))
    t = _SpyTransport(str(tmp_path / "chunks"), device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        PluginRunner(pl, t).run()
    assert t.closed


# ========================================== against the JAX package
def _jax_pair(seed=5, n_det=24, n_angles=30, n_rows=2):
    """The same v2 spec for both packages and one scan (simulated by the
    JAX package) given to both loaders."""
    scan = JT.simulate_raw_scan(JT.phantom_stack(n_det, n_rows),
                                JT.ParallelGeometry(n_angles, n_det, n_rows),
                                seed=seed)
    kw = {"n_det": n_det, "n_angles": n_angles, "n_rows": n_rows}
    port = from_spec(_spec(seed=seed, **kw))
    port.entries[0].params["scan"] = scan
    jax_pl = JS.from_spec(_spec(seed=seed, device=None, **kw))
    jax_pl.entries[0].params["scan"] = scan
    runner = PluginRunner(port, CudaTransport("cpu"))
    jrunner = R.PluginRunner(jax_pl, R.InMemoryTransport())
    runner.enable_streaming()
    jrunner.enable_streaming()
    return runner, jrunner, scan["data"]


def test_streamed_chain_matches_jax_streamed_chain():
    runner, jrunner, frames = _jax_pair()
    for lo, hi in _slabs(frames.shape[0]):
        for r in (runner, jrunner):
            assert r.feed(frames[lo:hi], lo) == hi
            r.pump()
    for r in (runner, jrunner):
        r.mark_eof()
        r.pump()
        r.finalise()
    got = runner.transport.read(runner.datasets["recon"])
    want = np.asarray(jrunner.transport.read(jrunner.datasets["recon"]))
    np.testing.assert_allclose(got, want, **CHAIN_TOL)
    print(f"streamed chain, port vs JAX: max abs err "
          f"{np.abs(got - want).max():.3e}")


def test_preview_matches_jax_preview_at_watermark():
    runner, jrunner, frames = _jax_pair(seed=6)
    watermark = 13
    for r in (runner, jrunner):
        r.feed(frames[:watermark], 0)
        r.pump()
    got, cut = runner.preview()
    want, jcut = jrunner.preview()
    assert cut == jcut == watermark
    assert got.shape == np.asarray(want).shape == (2, 24, 24)
    np.testing.assert_allclose(got, np.asarray(want), **CHAIN_TOL)
    # the live runner is untouched: the stream goes on to the batch result
    runner.feed(frames[watermark:], watermark)
    runner.mark_eof()
    runner.pump()
    assert runner.current_step == runner.n_steps


# ================================================== scheduler mode
def _drain(sched, timeout=60):
    try:
        assert sched.drain(timeout=timeout)
    finally:
        sched.shutdown()


def test_scheduler_drives_stream_filled_by_another_thread():
    """A streaming job driven by PipelineScheduler while a producer
    thread fills ``Job.stream`` (through ``ingest_frames``) slab by slab:
    bit for bit the batch run; the window metrics are recorded."""
    from repro_torch.obs import MetricsRegistry
    spec = _spec(seed=3)
    want = _reference(spec)
    frames = _frames(spec)
    q = JobQueue()
    metrics = MetricsRegistry()
    sched = PipelineScheduler(
        q, n_workers=1, metrics=metrics,
        transport_factory=lambda job: CudaTransport("cpu"))
    job = q.submit(from_spec(spec), job_id="scan0")
    assert job.streaming
    sched.start()

    def produce():
        for lo, hi in _slabs(frames.shape[0]):
            sched.ingest_frames("scan0", frames[lo:hi], lo)
        sched.mark_eof("scan0")

    try:
        t = threading.Thread(target=produce)
        t.start()
        t.join(timeout=60)
    finally:
        _drain(sched)
    assert job.state is JobState.DONE, job.snapshot()
    assert job.frames_consumed == frames.shape[0]
    got = job.runner.transport.read(job.runner.datasets["recon"])
    np.testing.assert_array_equal(got, want)
    assert metrics.histogram("stream.window_latency_s").count >= 1
    assert metrics.counter("stream.frames.ingested").value == \
        frames.shape[0]
    with pytest.raises(RuntimeError, match="out-of-order|closed"):
        sched.ingest_frames("scan0", frames[:1], 0)


def test_checkpoint_mid_stream_resumes_in_fresh_scheduler(tmp_path):
    """stream_state/restore_stream_state through a checkpoint: the first
    scheduler is shut down mid-stream, the same job id resubmitted to a
    fresh queue and scheduler with the same store resumes at the
    checkpointed watermark and finishes bit for bit."""
    spec = _spec(seed=7)
    want = _reference(spec)
    frames = _frames(spec)
    half = frames.shape[0] // 2
    store = CheckpointStore(str(tmp_path))

    def start():
        q = JobQueue()
        sched = PipelineScheduler(
            q, n_workers=1, checkpoints=store,
            transport_factory=lambda job: CudaTransport("cpu"))
        return q, sched.start()

    q1, s1 = start()
    try:
        job1 = q1.submit(from_spec(spec), job_id="scan7")
        s1.ingest_frames("scan7", frames[:5], 0)
        s1.ingest_frames("scan7", frames[5:half], 5)
        pause = threading.Event()
        for _ in range(600):                 # at most 30 s
            if job1.frames_consumed == half and \
                    (store.load("scan7") or {}).get("stream", {}).get(
                        "ingested") == half:
                break
            pause.wait(0.05)
    finally:
        s1.shutdown()
    assert job1.state is JobState.FAILED and "mid-stream" in job1.error
    man = store.load("scan7")
    assert man["stream"] == {"dataset": "tomo", "axis": "rotation_angle",
                             "ingested": half, "eof": False,
                             "total": frames.shape[0]}
    assert man["completed_steps"] == 0 and man["required"] == ["tomo"]

    q2, s2 = start()
    try:
        job2 = q2.submit(from_spec(spec), job_id="scan7")
        with pytest.raises(RuntimeError, match="out-of-order"):
            s2.ingest_frames("scan7", frames[:1], 0)
        s2.ingest_frames("scan7", frames[half:], half)
        s2.mark_eof("scan7")
    finally:
        _drain(s2)
    assert job2.state is JobState.DONE, job2.snapshot()
    got = job2.runner.transport.read(job2.runner.datasets["recon"])
    np.testing.assert_array_equal(got, want)
    assert store.load("scan7") is None       # cleared on completion


# ============================================================ broker mode
@pytest.fixture
def slow_plugins(monkeypatch):
    """The test plugins (``torch_slow_plugins``) in a copy of the wire
    registry, restored afterwards."""
    monkeypatch.setattr(wire, "_REGISTRY", dict(wire._REGISTRY))
    for cls in importlib.import_module("torch_slow_plugins").PLUGINS:
        wire.register_plugin(cls)


def _broker(lease_ttl, sweep_interval=0.1):
    svc = PipelineService(device="cpu", workers_remote=True,
                          lease_ttl=lease_ttl, sweep_interval=sweep_interval)
    host, port = svc.serve(port=0)
    return svc, PipelineClient(f"http://{host}:{port}", timeout=60.0)


def test_starved_stream_parks_lease(tmp_path):
    """A streaming job with no frames left to chew hands its lease back
    (verdict ``parked``) instead of camping on it; once frames land the
    job re-leases, restores the checkpoint's ingest watermark, and
    finishes bit-identical."""
    svc, client = _broker(lease_ttl=5.0)
    spec = _spec(seed=31)
    frames = _frames(spec)
    w = PipelineWorker(client.base_url, device="cpu", worker_id="sw",
                       poll=0.01, checkpoint_dir=str(tmp_path / "ck"),
                       preview_interval=0.0)
    try:
        jid = client.submit(spec)
        client.ingest(jid, frames[:6], 0)
        w.register()
        assert w.run_once() is True               # leases, feeds 6, parks
        snap = client.status(jid)
        assert snap["state"] == "queued", snap    # back in the queue...
        assert snap["frames_consumed"] == 6
        assert client.stats()["leases_expired"] == 0   # ...no expiry
        assert any(line.startswith("jobs_parked ")
                   and int(line.split()[1]) >= 1
                   for line in client.metrics().splitlines())
        client.ingest(jid, frames[6:], 6)
        client.eof(jid)
        assert w.run_once() is True               # resumes at frame 6
        snap = client.wait(jid, timeout=60)
        assert snap["state"] == "done", snap
        assert snap["frames_consumed"] == frames.shape[0]
        assert snap["attempt"] >= 2               # park ended lease #1
        np.testing.assert_array_equal(client.result(jid),
                                      _reference(spec))
    finally:
        svc.stop()


def test_broker_mode_records_window_latency(tmp_path):
    """``stream.window_latency_s`` is observed in broker mode too: the
    worker times each ``pump`` and ships the measurement transiently on
    its next progress post, where the broker folds it into the
    histogram; the worker's preview lands on ``GET /jobs/{id}/preview``."""
    svc, client = _broker(lease_ttl=5.0)
    spec = _spec(seed=37)
    frames = _frames(spec)
    w = PipelineWorker(client.base_url, device="cpu", worker_id="lw",
                       poll=0.01, checkpoint_dir=str(tmp_path / "ck"),
                       preview_interval=0.001)
    try:
        jid = client.submit(spec)
        client.ingest(jid, frames, 0)
        client.eof(jid)
        w.register()
        deadline = time.time() + 120
        while client.status(jid)["state"] not in ("done", "failed"):
            w.run_once()
            assert time.time() < deadline, client.status(jid)
        assert client.status(jid)["state"] == "done"
        want = _reference(spec)
        np.testing.assert_array_equal(client.result(jid), want)
        counts = {line.split()[0]: float(line.split()[1])
                  for line in client.metrics().splitlines()
                  if line and not line.startswith("#")}
        assert counts.get("stream_window_latency_s_count", 0) >= 1, \
            "broker mode never observed stream.window_latency_s"
        arr, covered = client.preview(jid)
        assert arr.shape == want.shape and covered == frames.shape[0]
    finally:
        svc.stop()


def test_stream_worker_sigkill_resumes_from_watermark(tmp_path,
                                                      slow_plugins):
    """SIGKILL the worker mid-pump: the lease expires, the next owner
    restores the checkpoint's ingest watermark, refetches the retained
    frame buffers it never saw, and finishes bit-identical to batch."""
    svc, client = _broker(lease_ttl=1.5)
    workers = spawn_local_workers(
        client.base_url, 2, transport="cuda", device="cpu",
        checkpoint_dir=str(tmp_path / "ckpts"), poll=0.05, heartbeat=0.3,
        imports=("torch_slow_plugins",), worker_ids=["w0", "w1"],
        pythonpath_extra=(TESTS_DIR,))
    by_id = dict(zip(["w0", "w1"], workers))
    try:
        spec = _slow_spec(seed=41, delay=1.5)     # 1.5 s per pumped slab
        frames = _frames(spec)
        jid = client.submit(spec)
        client.ingest(jid, frames[:6], 0)
        # first slab chewed + checkpointed (watermark 6)
        deadline = time.time() + 120
        while True:
            snap = client.status(jid)
            if snap.get("frames_consumed", 0) >= 6:
                break
            assert snap["state"] not in ("done", "failed"), snap
            assert time.time() < deadline, f"slab never consumed: {snap}"
            time.sleep(0.05)
        # second slab: kill the owner mid-pump
        client.ingest(jid, frames[6:12], 6)
        while True:
            snap = client.status(jid)
            if snap["state"] == "running" and snap["worker_id"]:
                break
            assert snap["state"] not in ("done", "failed"), snap
            assert time.time() < deadline, f"never re-leased: {snap}"
            time.sleep(0.05)
        victim = snap["worker_id"]
        time.sleep(0.4)                           # into the slow pump
        os.kill(by_id[victim].pid, signal.SIGKILL)
        client.ingest(jid, frames[12:], 12)
        client.eof(jid)
        snap = client.wait(jid, timeout=120)
        assert snap["state"] == "done", snap
        assert snap["frames_consumed"] == frames.shape[0]
        assert snap["attempt"] >= 2, snap
        np.testing.assert_array_equal(client.result(jid),
                                      _reference(spec))
        assert client.stats()["leases_expired"] >= 1
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
        for p in workers:
            p.wait(timeout=10)
        svc.stop()
