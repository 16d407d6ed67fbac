"""Streaming acquisition in the port against tests/test_streaming.py:
a runner fed random-size slabs through ``enable_streaming``/``feed``/
``pump`` gives the batch run's reconstruction bit for bit, with a
preview mid-stream; bad feeds are rejected with the same messages;
``run()`` closes the transport on failure.  Plus: the port's streamed
chain and preview against the JAX package's on the same slabs, a
checkpoint mid-stream resumed by a fresh scheduler bit for bit, and a
streaming job driven by ``PipelineScheduler`` from a stream another
thread fills."""
import threading

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
                                 PipelineScheduler, from_spec)
from repro_torch.tomo.plugins import HDF5LikeSaver, SyntheticTomoLoader

#: the chain bound (tests/test_tomo_pipeline.py)
CHAIN_TOL = {"rtol": 1e-3, "atol": 1e-4}


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
