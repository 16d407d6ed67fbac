"""The port's in-process service layer against the JAX package's
(tests/test_service.py): queue ordering, priorities and admission
control, cancel races, history pruning, stepping/resume, the shared
built-step cache, gang batching on ``CudaTransport("cpu")`` — plus the
gang-batched chain against the JAX scheduler's on the same scans, and
the port's own concurrency and device rules."""
import threading
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import repro.service as JS
import repro.tomo as JT
from repro.core import ShardedTransport

from repro_torch.core import (BaseFilter, BaseLoader, BaseSaver,
                              CudaTransport, DataSet, InMemoryTransport,
                              LambdaFilter, PluginRunner, ProcessList)
from repro_torch.service import (CheckpointStore, CompileCache, JobQueue,
                                 JobState, PipelineScheduler, QueueFull,
                                 chain_signature)
from repro_torch.obs import EventLog, MetricsRegistry
from repro_torch.tomo import standard_chain

#: the chain bound (tests/test_tomo_pipeline.py)
CHAIN_TOL = {"rtol": 1e-3, "atol": 1e-4}


# ---------------------------------------------------------------- helpers
class ArrayLoader(BaseLoader):
    name = "array_loader"
    parameters = {"array": None, "seed": None}
    data_params = ("array", "seed")

    def load(self):
        a = self.params["array"]
        d = DataSet(self.out_dataset_names[0], a.shape, a.dtype,
                    ("theta", "y", "x"), backing=a)
        d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
        return [d]


class NullSaver(BaseSaver):
    name = "null_saver"

    def save(self, ds):
        ds.metadata["saved"] = True


class TraceFilter(BaseFilter):
    """Records every pre_process (one per executed plugin step)."""
    name = "trace_filter"
    parameters = {"add": 0.0, "tag": ""}
    executed: list = []         # class-level log, reset per test

    def pre_process(self):
        TraceFilter.executed.append(self.params["tag"])

    def process_frames(self, frames):
        return frames[0] + self.params["add"]


def _trace_chain(a, n_filters=4):
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("d",))
    for i in range(n_filters):
        pl.add(TraceFilter, params={"add": float(i + 1), "tag": f"f{i}"},
               in_datasets=("d",), out_datasets=("d",))
    pl.add(NullSaver, in_datasets=("d",))
    return pl


def _double(b):
    return b * 2.0


def _inc(b):
    return b + 1.0


def _lambda_chain(a):
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("d",))
    pl.add(LambdaFilter, params={"fn": _double, "pattern": "PROJECTION"},
           in_datasets=("d",), out_datasets=("d",))
    pl.add(LambdaFilter, params={"fn": _inc, "pattern": "PROJECTION"},
           in_datasets=("d",), out_datasets=("d",))
    pl.add(NullSaver, in_datasets=("d",))
    return pl


def _cpu():
    return InMemoryTransport(device="cpu")


def _sched(q, **kw):
    """A scheduler whose jobs run on the CPU (the default is the card)."""
    kw.setdefault("transport_factory", lambda job: _cpu())
    return PipelineScheduler(q, **kw)


@pytest.fixture
def data(rng):
    return rng.normal(size=(4, 6, 5)).astype(np.float32)


# ---------------------------------------------------------------- queue
def test_queue_priority_then_fifo(data):
    q = JobQueue()
    lo1 = q.submit(_trace_chain(data), priority=0)
    hi = q.submit(_trace_chain(data), priority=5)
    lo2 = q.submit(_trace_chain(data), priority=0)
    assert q.get(0).job_id == hi.job_id
    assert q.get(0).job_id == lo1.job_id     # FIFO within a priority
    assert q.get(0).job_id == lo2.job_id
    assert q.get(timeout=0.01) is None


def test_admission_control_backpressure(data):
    q = JobQueue(max_pending=2)
    j1 = q.submit(_trace_chain(data))
    q.submit(_trace_chain(data))
    with pytest.raises(QueueFull):
        q.submit(_trace_chain(data))
    with pytest.raises(QueueFull):
        q.submit(_trace_chain(data), block=True, timeout=0.05)

    def finish():
        time.sleep(0.05)
        j1.state = JobState.DONE
        q.notify_terminal()
    t = threading.Thread(target=finish)
    t.start()
    j3 = q.submit(_trace_chain(data), block=True, timeout=5.0)
    t.join()
    assert j3.state is JobState.QUEUED


def test_cancel_before_dispatch(data):
    q = JobQueue()
    a = q.submit(_trace_chain(data))
    b = q.submit(_trace_chain(data))
    assert q.cancel(a.job_id)
    assert q.get(0).job_id == b.job_id
    assert q.get(timeout=0.01) is None
    assert a.state is JobState.CANCELLED
    assert not q.cancel(b.job_id)            # already dispatched


def test_chain_signature_ignores_data_params():
    s0 = chain_signature(standard_chain(n_det=16, n_angles=16, seed=0))
    s1 = chain_signature(standard_chain(n_det=16, n_angles=16, seed=7))
    assert s0 == s1                          # same pipeline, new dataset
    s2 = chain_signature(standard_chain(n_det=16, n_angles=16, ring=False))
    assert s0 != s2                          # different pipeline


def test_get_batch_members_join_in_dispatch_order(data):
    q = JobQueue()
    head = q.submit(_trace_chain(data), priority=9)
    members = [q.submit(_trace_chain(data), priority=0) for _ in range(4)]
    batch = q.get_batch(max_jobs=3, timeout=0)
    assert [j.job_id for j in batch] == \
        [head.job_id, members[0].job_id, members[1].job_id]
    assert q.get(0).job_id == members[2].job_id
    assert q.get(0).job_id == members[3].job_id


def test_get_batch_prefers_higher_priority_members(data):
    q = JobQueue()
    head = q.submit(_trace_chain(data), priority=9)
    lo = q.submit(_trace_chain(data), priority=0)
    hi = q.submit(_trace_chain(data), priority=5)
    batch = q.get_batch(max_jobs=2, timeout=0)
    assert [j.job_id for j in batch] == [head.job_id, hi.job_id]
    assert q.get(0).job_id == lo.job_id


def test_get_batch_groups_identical_chains(data, rng):
    other = rng.normal(size=(4, 6, 5)).astype(np.float32)
    q = JobQueue()
    a = q.submit(_trace_chain(data))
    b = q.submit(_trace_chain(other))        # same chain, other data
    c = q.submit(_trace_chain(data, n_filters=2))   # different chain
    batch = q.get_batch(max_jobs=4, timeout=0)
    assert {j.job_id for j in batch} == {a.job_id, b.job_id}
    assert q.get(0).job_id == c.job_id


def test_cancel_running_job_is_rejected(data):
    q = JobQueue()
    job = q.submit(_trace_chain(data))
    assert q.get(0).job_id == job.job_id     # dispatched: CHECKING
    assert not q.cancel(job.job_id)
    job.state = JobState.RUNNING
    assert not q.cancel(job.job_id)
    assert job.state is JobState.RUNNING     # untouched
    job.state = JobState.DONE
    assert not q.cancel(job.job_id)          # terminal: still rejected


def test_cancel_race_with_dispatch(data):
    for _ in range(25):
        q = JobQueue()
        job = q.submit(_trace_chain(data))
        results = {}
        barrier = threading.Barrier(2)

        def dispatch():
            barrier.wait()
            results["got"] = q.get(timeout=0.2)

        def cancel():
            barrier.wait()
            results["cancelled"] = q.cancel(job.job_id)

        ts = [threading.Thread(target=dispatch),
              threading.Thread(target=cancel)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if results["cancelled"]:
            assert results["got"] is None
            assert job.state is JobState.CANCELLED
        else:
            assert results["got"] is not None
            assert job.state is JobState.CHECKING


def test_cancelled_jobs_are_pruned(data):
    q = JobQueue(max_history=1)
    stale = [q.submit(_trace_chain(data)) for _ in range(3)]
    for j in stale:
        assert q.cancel(j.job_id)
    q.submit(_trace_chain(data))             # submit triggers pruning
    ids = {s["job_id"] for s in q.snapshot()}
    assert stale[0].job_id not in ids and stale[1].job_id not in ids
    assert stale[2].job_id in ids            # newest terminal retained


def test_cancel_frees_admission_capacity(data):
    q = JobQueue(max_pending=1)
    j1 = q.submit(_trace_chain(data))

    def free():
        time.sleep(0.05)
        q.cancel(j1.job_id)
    t = threading.Thread(target=free)
    t.start()
    j2 = q.submit(_trace_chain(data), block=True, timeout=5.0)
    t.join()
    assert j2.state is JobState.QUEUED


def test_wait_all_returns_when_last_job_cancelled(data):
    q = JobQueue()
    jobs = [q.submit(_trace_chain(data)) for _ in range(2)]
    assert not q.wait_all(timeout=0.05)      # nothing ran yet
    for j in jobs:
        assert q.cancel(j.job_id)
    assert q.wait_all(timeout=5.0)


def test_wait_all_with_scheduler_and_cancelled_tail(data):
    TraceFilter.executed = []
    q = JobQueue()
    head = q.submit(_trace_chain(data))
    tail = q.submit(_trace_chain(data))
    assert q.cancel(tail.job_id)
    sched = _sched(q, n_workers=1).start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert head.state is JobState.DONE
    assert tail.state is JobState.CANCELLED
    assert len(TraceFilter.executed) == 4    # only the head's 4 filters


# ---------------------------------------------------------- stepping/resume
def test_stepping_equals_run(data):
    r1 = PluginRunner(_trace_chain(data), _cpu())
    out1 = r1.run()
    r2 = PluginRunner(_trace_chain(data), _cpu())
    r2.prepare()
    assert r2.n_steps == 4
    steps = 0
    while r2.step():
        steps += 1
    r2.finalise()
    assert steps == 4
    np.testing.assert_allclose(r1.transport.read(out1["d"]),
                               r2.transport.read(r2.datasets["d"]))


def test_kill_then_resume_recovers_at_correct_plugin(tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    ref = PluginRunner(_trace_chain(data), _cpu())
    want = ref.transport.read(ref.run()["d"])

    TraceFilter.executed = []
    r = PluginRunner(_trace_chain(data), _cpu())
    r.prepare()
    for _ in range(2):
        r.step()
        store.save("j1", r)
    assert TraceFilter.executed == ["f0", "f1"]

    TraceFilter.executed = []
    r2 = PluginRunner(_trace_chain(data), _cpu())
    assert store.restore("j1", r2) == 2
    while r2.step():
        pass
    r2.finalise()
    assert TraceFilter.executed == ["f2", "f3"]     # f0/f1 NOT re-run
    np.testing.assert_allclose(r2.transport.read(r2.datasets["d"]), want)


def test_restore_rejects_different_chain(tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(_trace_chain(data), _cpu())
    r.prepare()
    r.step()
    store.save("j1", r)
    other = PluginRunner(_trace_chain(data, n_filters=2), _cpu())
    assert store.restore("j1", other) == 0          # signature mismatch


def test_scheduler_resumes_resubmitted_job(tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    ref = PluginRunner(_trace_chain(data), _cpu())
    want = ref.transport.read(ref.run()["d"])
    r = PluginRunner(_trace_chain(data), _cpu())
    r.prepare()
    r.step()
    store.save("jobX", r)

    TraceFilter.executed = []
    q = JobQueue()
    sched = _sched(q, n_workers=1, checkpoints=store).start()
    try:
        job = q.submit(_trace_chain(data), job_id="jobX")
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert job.state is JobState.DONE, job.snapshot()
    assert job.resumed_from == 1
    assert TraceFilter.executed == ["f1", "f2", "f3"]
    got = job.runner.transport.read(job.runner.datasets["d"])
    np.testing.assert_allclose(got, want)


def test_gang_path_resumes_checkpointed_job(tmp_path, data, rng):
    store = CheckpointStore(str(tmp_path))
    ref = PluginRunner(_trace_chain(data), _cpu())
    want = ref.transport.read(ref.run()["d"])
    r = PluginRunner(_trace_chain(data), _cpu())
    r.prepare()
    r.step()
    store.save("jobX", r)

    other = rng.normal(size=data.shape).astype(np.float32)
    TraceFilter.executed = []
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, checkpoints=store, batch_identical=True,
        batch_max=4, transport_factory=lambda job: CudaTransport("cpu"))
    jx = q.submit(_trace_chain(data), job_id="jobX")
    jy = q.submit(_trace_chain(other), job_id="jobY")
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert jx.state is JobState.DONE, jx.snapshot()
    assert jy.state is JobState.DONE, jy.snapshot()
    assert jx.resumed_from == 1
    assert jy.resumed_from == 0
    assert TraceFilter.executed.count("f0") == 1     # only jobY ran f0
    got = jx.runner.transport.read(jx.runner.datasets["d"])
    np.testing.assert_allclose(got, want)


# ---------------------------------------------------------- scheduler
def test_scheduler_concurrent_jobs_match_serial(rng):
    arrays = [rng.normal(size=(4, 5, 5)).astype(np.float32)
              for _ in range(3)]
    q = JobQueue()
    sched = _sched(q, n_workers=2).start()
    try:
        jobs = [q.submit(_trace_chain(a)) for a in arrays]
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    for a, j in zip(arrays, jobs):
        assert j.state is JobState.DONE, j.snapshot()
        ref = PluginRunner(_trace_chain(a), _cpu())
        want = ref.transport.read(ref.run()["d"])
        got = j.runner.transport.read(j.runner.datasets["d"])
        np.testing.assert_allclose(got, want)


def test_scheduler_marks_failed_job(data):
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": data}, out_datasets=("d",))
    pl.add(LambdaFilter,
           params={"fn": lambda b: (_ for _ in ()).throw(RuntimeError("boom")),
                   "pattern": "PROJECTION"},
           in_datasets=("d",), out_datasets=("d",))
    pl.add(NullSaver, in_datasets=("d",))
    q = JobQueue()
    sched = _sched(q, n_workers=1).start()
    try:
        job = q.submit(pl)
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert job.state is JobState.FAILED
    assert "boom" in job.error
    assert "running" not in job.status


def test_scheduler_without_factory_defaults_to_the_card(data, monkeypatch):
    """The default factory runs jobs on the card: without one the
    scheduler raises at construction; a factory of CPU transports runs
    them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        PipelineScheduler(JobQueue())
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1,
        transport_factory=lambda job: InMemoryTransport("cpu")).start()
    try:
        job = q.submit(_trace_chain(data))
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert job.state is JobState.DONE, job.snapshot()
    assert job.runner.transport.device.type == "cpu"


# ------------------------------------------------------- compile cache
def test_compile_cache_hit_on_resubmitted_process_list(data, rng):
    cache = CompileCache()

    def run_once(a):
        tr = CudaTransport("cpu", compile_cache=cache)
        out = PluginRunner(_lambda_chain(a), tr).run()
        return tr.read(out["d"])

    got1 = run_once(data)
    after_first = cache.stats()
    assert after_first["misses"] == 2 and after_first["hits"] == 0
    other = rng.normal(size=data.shape).astype(np.float32)
    got2 = run_once(other)                   # identical list, new dataset
    after_second = cache.stats()
    assert after_second["misses"] == 2       # zero new builds
    assert after_second["hits"] == 2
    np.testing.assert_allclose(got1, data * 2 + 1, rtol=1e-5)
    np.testing.assert_allclose(got2, other * 2 + 1, rtol=1e-5)


def test_compile_cache_single_build_under_race():
    cache = CompileCache()
    builds = []

    def builder():
        time.sleep(0.05)
        builds.append(1)
        return "artifact"

    results = []
    threads = [threading.Thread(
        target=lambda: results.append(cache.get_or_build("k", builder)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == ["artifact"] * 4
    assert len(builds) == 1                  # losers waited, not rebuilt


def test_compile_cache_persistent_tier_not_ported():
    for kw in ({"store": "/nowhere"}, {"fetch": lambda s: None},
               {"publish": lambda s, b: None}):
        with pytest.raises(NotImplementedError, match="D3"):
            CompileCache(**kw)


class BiasFilter(BaseFilter):
    """A per-job constant (the bias) built in setup."""
    name = "bias_filter"
    pattern_name = "PROJECTION"
    parameters = {"which": 0, "delay": 0.0}
    data_params = ("which",)

    def setup(self, in_datasets):
        (din,) = in_datasets
        self._bias = torch.full(din.shape[1:], float(self.params["which"]))
        dout = din.like(self.out_dataset_names[0])
        self.chunk_frames(self.pattern_name, 1)
        return [dout]

    def process_frames(self, frames):
        bias = self._bias
        time.sleep(self.params["delay"])     # widens any binding race
        return frames[0] + bias[None] + (self._bias - bias)[None]


def _bias_chain(a, which, delay=0.0):
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("d",))
    pl.add(BiasFilter, params={"which": which, "delay": delay},
           in_datasets=("d",), out_datasets=("d",))
    pl.add(NullSaver, in_datasets=("d",))
    return pl


def test_jit_constants_flow_as_arguments(rng):
    """Two plugin instances with different setup constants share one
    built step and still get THEIR OWN constants applied."""
    cache = CompileCache()
    a = rng.normal(size=(3, 4, 4)).astype(np.float32)
    tr = CudaTransport("cpu", compile_cache=cache)
    out5 = tr.read(PluginRunner(_bias_chain(a, 5), tr).run()["d"])
    tr2 = CudaTransport("cpu", compile_cache=cache)
    out9 = tr2.read(PluginRunner(_bias_chain(a, 9), tr2).run()["d"])
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1
    np.testing.assert_allclose(out5, a + 5, rtol=1e-6)
    np.testing.assert_allclose(out9, a + 9, rtol=1e-6)   # not stale 5!


def test_shared_step_binds_constants_per_call(rng):
    """Two jobs run one built step at the same time on two threads, each
    with its own constants: neither sees the other's (the step binds
    its constants on a copy of the plugin, not on the shared one)."""
    cache = CompileCache()
    a = rng.normal(size=(2, 3, 3)).astype(np.float32)
    outs = {}

    def run(which):
        tr = CudaTransport("cpu", compile_cache=cache)
        outs[which] = tr.read(
            PluginRunner(_bias_chain(a, which, delay=0.2), tr).run()["d"])

    threads = [threading.Thread(target=run, args=(w,)) for w in (3, 7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert cache.stats()["misses"] == 1
    np.testing.assert_allclose(outs[3], a + 3, rtol=1e-6)
    np.testing.assert_allclose(outs[7], a + 7, rtol=1e-6)


def test_max_history_evicts_terminal_jobs(data):
    q = JobQueue(max_history=2)
    sched = _sched(q, n_workers=1).start()
    try:
        jobs = [q.submit(_trace_chain(data)) for _ in range(4)]
        assert sched.drain(timeout=60)
        q.submit(_trace_chain(data))
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert all(j.state is JobState.DONE for j in jobs)
    ids = {s["job_id"] for s in q.snapshot()}
    assert jobs[0].job_id not in ids and jobs[1].job_id not in ids
    assert jobs[0].runner is None            # memory released


# ------------------------------------------------------- gang batching
def test_gang_shape_mismatch_falls_back_to_solo(rng):
    """Members whose shapes differ share no built step: each step runs
    member by member, counted in ``gang.fallback`` and told in each
    member's events."""
    a = rng.normal(size=(4, 5, 5)).astype(np.float32)
    b = rng.normal(size=(4, 6, 6)).astype(np.float32)
    cache = CompileCache()
    q = JobQueue()
    metrics, events = MetricsRegistry(), EventLog()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        metrics=metrics, events=events,
        transport_factory=lambda job: CudaTransport(
            "cpu", compile_cache=cache))
    jobs = [q.submit(_lambda_chain(x)) for x in (a, b)]
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    for x, j in zip((a, b), jobs):
        assert j.state is JobState.DONE, j.snapshot()
        got = j.runner.transport.read(j.runner.datasets["d"])
        np.testing.assert_allclose(got, x * 2 + 1, rtol=1e-5)
    # both lambda steps mismatch; the loader and saver run no step
    assert sched.gang_fallbacks == 2
    assert sched.stats()["gang_fallbacks"] == 2
    assert metrics.counter("gang.fallback").value == 2
    fell = [e for e in events.since(0)["events"]
            if e["event"] == "gang.fallback"]
    assert sorted(e["job_id"] for e in fell) == sorted(
        [j.job_id for j in jobs] * 2)
    assert all("batch signature" in e["attrs"]["reason"] for e in fell)


class _BatchedHookFails(BiasFilter):
    """A per-job constant whose gang hook raises ValueError: a fault of
    the gang path itself, not a signature mismatch."""
    name = "bias_filter_bad_hook"

    def process_frames_batched(self, frames, consts, counts):
        raise ValueError("bad hook")


def test_gang_step_error_fails_the_gang(rng):
    """A ValueError raised inside a gang step fails the gang's jobs: it
    is not taken for a signature mismatch and hidden by solo runs."""
    a = rng.normal(size=(3, 4, 4)).astype(np.float32)
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        transport_factory=lambda job: CudaTransport("cpu"))
    jobs = []
    for w in (1, 2):
        pl = ProcessList()
        pl.add(ArrayLoader, params={"array": a}, out_datasets=("d",))
        pl.add(_BatchedHookFails, params={"which": w},
               in_datasets=("d",), out_datasets=("d",))
        pl.add(NullSaver, in_datasets=("d",))
        jobs.append(q.submit(pl))
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert sched.gang_fallbacks == 0
    for j in jobs:
        assert j.state is JobState.FAILED, j.snapshot()
        assert "bad hook" in j.error


def test_gang_batch_matches_serial(rng):
    arrays = [rng.normal(size=(4, 5, 5)).astype(np.float32)
              for _ in range(3)]
    cache = CompileCache()
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        compile_cache=cache,
        transport_factory=lambda job: CudaTransport(
            "cpu", compile_cache=cache))
    jobs = [q.submit(_lambda_chain(a)) for a in arrays]
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert sched.gangs_run == 1
    for a, j in zip(arrays, jobs):
        assert j.state is JobState.DONE, j.snapshot()
        got = j.runner.transport.read(j.runner.datasets["d"])
        np.testing.assert_allclose(got, a * 2 + 1, rtol=1e-5)


def test_gang_members_keep_their_own_constants(rng):
    """A gang whose members' constants differ and whose plugin has no
    batched hook runs the step once per member, counted as a gang
    fallback (never a quiet solo run): each member gets its own bias,
    bit for bit as alone."""
    a = rng.normal(size=(3, 4, 4)).astype(np.float32)
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        transport_factory=lambda job: CudaTransport("cpu"))
    jobs = [q.submit(_bias_chain(a, w)) for w in (1, 2, 3)]
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert sched.gangs_run == 1
    assert sched.gang_fallbacks == 1
    for w, j in zip((1, 2, 3), jobs):
        got = j.runner.transport.read(j.runner.datasets["d"])
        np.testing.assert_array_equal(got, a + np.float32(w))


# ------------------------------------------ parity with the JAX scheduler
def test_gang_chain_matches_jax_gang():
    """Three scans of ``standard_chain(n_det=32, n_angles=24, n_rows=2)``
    (seeds 0-2, the same simulated scan given to both packages)
    gang-batched by the port's scheduler on ``CudaTransport("cpu")`` and
    by the JAX scheduler on a one-device ``ShardedTransport``: within
    the chain bound."""
    geom = JT.ParallelGeometry(24, 32, 2)
    vol = JT.phantom_stack(32, 2)
    scans = [JT.simulate_raw_scan(vol, geom, seed=s) for s in range(3)]
    kw = {"n_det": 32, "n_angles": 24, "n_rows": 2}

    def chain(mod_chain, scan, **extra):
        pl = mod_chain(**kw, **extra)
        pl.entries[0].params["scan"] = scan
        return pl

    q = JobQueue()
    cache = CompileCache()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        compile_cache=cache,
        transport_factory=lambda job: CudaTransport(
            "cpu", compile_cache=cache))
    jobs = [q.submit(chain(standard_chain, s, device="cpu")) for s in scans]
    sched.start()
    try:
        assert sched.drain(timeout=60)
    finally:
        sched.shutdown()
    assert sched.gangs_run == 1

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jq = JS.JobQueue()
    jsched = JS.PipelineScheduler(
        jq, n_workers=1, batch_identical=True, batch_max=4,
        transport_factory=lambda job: ShardedTransport(mesh, donate=False))
    jjobs = [jq.submit(chain(JT.standard_chain, s, use_pallas=False))
             for s in scans]
    jsched.start()
    try:
        assert jsched.drain(timeout=120)
    finally:
        jsched.shutdown()
    assert jsched.gangs_run == 1
    worst = 0.0
    for j, jj in zip(jobs, jjobs):
        assert j.state is JobState.DONE, j.snapshot()
        assert jj.state is JS.JobState.DONE, jj.snapshot()
        got = j.runner.transport.read(j.runner.datasets["recon"])
        want = np.asarray(jj.runner.transport.read(
            jj.runner.datasets["recon"]))
        np.testing.assert_allclose(got, want, **CHAIN_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"gang chain, port vs JAX: max abs err {worst:.3e}")
