"""The program's spans of the runner and the transport, on CPU devices:
``runner.prepare`` around a runner's set-up, ``transport.to_device``
around each hand-off of host data to the transport's device,
``transport.to_host`` around each read of a device-resident dataset,
``transport.alltoall`` around each re-split between slots;
each on the epoch clock, on the trace of the request that owns the
dataset (each member's own inside a gang); and the ``compile`` spans of
a step built inside a closed loop or a gang step, which reach a
request's trace now that the runner and the gang step bind one."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (CudaTransport, DataSet, InMemoryTransport,
                              PluginRunner, ShardedTransport)
from repro_torch.obs import Trace, current_trace, use_trace
from repro_torch.service import (CompileCache, JobQueue, JobState,
                                 PipelineScheduler)
from repro_torch.tomo import standard_chain

CHAIN = dict(n_det=16, n_angles=12, n_rows=4, device="cpu")
COPIES = ("transport.to_device", "transport.to_host")


def _named(trace, name):
    return [s for s in trace.spans() if s.name == name]


def _run_and_read(transport, **chain):
    """One request: a runner over the standard chain, then the read of
    its volume; returns (runner, volume, t0, t1) with the request's
    wall on the epoch clock."""
    t0 = time.time()
    runner = PluginRunner(standard_chain(**{**CHAIN, **chain}), transport)
    datasets = runner.run()
    vol = transport.read(datasets["recon"])
    return runner, vol, t0, time.time()


def test_one_request_leaves_its_prepare_and_copies_on_its_trace():
    runner, vol, t0, t1 = _run_and_read(CudaTransport("cpu"))
    tr = runner.profiler.trace
    (prep,) = _named(tr, "runner.prepare")
    (host,) = _named(tr, "transport.to_host")
    dev = _named(tr, "transport.to_device")
    # the chain has one host input, the loader's raw scan
    raw = [ds for ds in runner.lineage if not ds.produced_by]
    assert len(dev) == len(raw) == 1
    assert dev[0].attrs == {"bytes": raw[0].nbytes, "dataset": "tomo",
                            "device": "cpu", "pinned": False}
    assert host.attrs == {"bytes": vol.nbytes, "dataset": "recon",
                          "device": "cpu", "pinned": False}
    for s in (prep, host, *dev):
        # epoch seconds (time.time()), inside the request's wall
        assert t0 <= s.start <= s.end <= t1
    setups = [s for s in tr.spans() if s.name.startswith("plugin.")
              and s.name.endswith(".setup")]
    assert len(setups) == 5
    assert all(s.parent_id == prep.span_id for s in setups)
    # the raw's copy lies inside the correction's process span
    (corr,) = _named(tr, "plugin.dark_flat_correction.process")
    assert dev[0].parent_id == corr.span_id


def test_copies_follow_the_dataset_and_not_the_current_trace():
    # a trace bound by a caller does not take the request's copies
    other = Trace()
    with use_trace(other):
        runner, _, _, _ = _run_and_read(CudaTransport("cpu"))
    assert not any(s.name in COPIES or s.name == "runner.prepare"
                   for s in other.spans())
    names = [s.name for s in runner.profiler.trace.spans()]
    assert names.count("transport.to_device") == 1
    assert names.count("transport.to_host") == 1
    # the steps it built record on the bound trace, as before
    assert len(_named(other, "compile")) == 4


def test_streaming_slab_copy_lands_on_its_dataset_trace():
    runner = PluginRunner(standard_chain(**CHAIN),
                          CudaTransport("cpu")).prepare()
    corr = runner._processors[0]
    raw = corr.in_data[0].dataset
    slab = raw.materialise()[:3]
    shape = (3,) + raw.shape[1:]
    (out,) = runner.transport.run_window(corr, [slab], [shape])
    assert tuple(out.shape) == shape
    (s,) = _named(runner.profiler.trace, "transport.to_device")
    assert s.attrs["bytes"] == slab.nbytes and s.attrs["dataset"] == "tomo"


def test_a_device_source_is_not_a_host_copy():
    # a tensor already on the transport's device is handed over as is
    ds = DataSet("d", (2, 3), np.float32, ("a", "b"),
                 backing=torch.ones(2, 3), trace=Trace())
    t = CudaTransport("cpu")._to_device(ds, ds.materialise())
    assert t is ds.backing and len(ds.trace) == 0


@pytest.mark.parametrize("transport", [InMemoryTransport, CudaTransport])
def test_a_read_with_no_trace_anywhere_records_nothing(transport):
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    backing = (torch.from_numpy(data.copy()) if transport is CudaTransport
               else data)
    ds = DataSet("d", (2, 3), np.float32, ("a", "b"), backing=backing)
    assert current_trace() is None
    np.testing.assert_array_equal(transport(device="cpu").read(ds), data)
    # with a current trace (a caller's), a device read falls back to it
    tr = Trace()
    with use_trace(tr):
        transport(device="cpu").read(ds)
    assert len(_named(tr, "transport.to_host")) == \
        (1 if transport is CudaTransport else 0)


def test_in_memory_transport_moves_nothing_off_a_card():
    runner, _, _, _ = _run_and_read(InMemoryTransport(device="cpu"))
    assert not any(s.name in COPIES for s in runner.profiler.trace.spans())
    assert len(_named(runner.profiler.trace, "runner.prepare")) == 1


def test_sharded_read_is_one_gather_span_with_its_slots():
    transport = ShardedTransport(("cpu",) * 4)
    runner, vol, t0, t1 = _run_and_read(transport)
    tr = runner.profiler.trace
    (host,) = _named(tr, "transport.to_host")
    assert host.attrs == {"bytes": vol.nbytes, "dataset": "recon",
                          "device": "cpu", "slots": 4, "pinned": False}
    (dev,) = _named(tr, "transport.to_device")
    raw = [ds for ds in runner.lineage if not ds.produced_by][0]
    assert dev.attrs["slots"] == 4 and dev.attrs["bytes"] == raw.nbytes
    assert t0 <= dev.start <= host.end <= t1


def test_the_all_to_all_is_one_span_on_the_requests_trace():
    """13 angles over 4 slots (4/3/3/3), projections to sinograms: one
    ``transport.alltoall`` span on the request's trace, inside the ring
    removal's step, carrying the bytes that crossed
    between slots: every entry of the corrected stack but the blocks a
    slot keeps for itself."""
    transport = ShardedTransport(("cpu",) * 4)
    t0 = time.time()
    runner = PluginRunner(standard_chain(**{**CHAIN, "n_angles": 13}),
                          transport)
    runner.run()
    tr = runner.profiler.trace
    (a2a,) = _named(tr, "transport.alltoall")
    # slot i holds angles a_i of every row; slot j takes rows j of them
    kept = sum(a * 1 * CHAIN["n_det"] * 4 for a in (4, 3, 3, 3))
    stack = 13 * CHAIN["n_rows"] * CHAIN["n_det"] * 4
    assert a2a.attrs == {"bytes": stack - kept, "dataset": "tomo",
                         "slots": 4, "from_dim": 0, "to_dim": 1}
    assert transport.stats()["alltoall_bytes"] == stack - kept
    (step,) = [s for s in tr.spans() if s.name.endswith(".process")
               and s.start <= a2a.start and a2a.end <= s.end]
    assert step.name == "plugin.ring_removal.process"
    assert t0 <= a2a.start <= a2a.end <= time.time()


def test_a_shared_compile_cache_builds_on_the_first_request_only():
    cache = CompileCache()
    first, _, _, _ = _run_and_read(CudaTransport("cpu", compile_cache=cache))
    second, _, _, _ = _run_and_read(CudaTransport("cpu", compile_cache=cache),
                                    seed=1)
    assert len(_named(first.profiler.trace, "compile")) == 4
    assert _named(second.profiler.trace, "compile") == []


def test_gang_members_copies_land_on_their_own_traces():
    cache = CompileCache()
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        compile_cache=cache,
        transport_factory=lambda job: CudaTransport(
            "cpu", compile_cache=cache))
    jobs = [q.submit(standard_chain(**CHAIN, seed=k)) for k in range(4)]
    sched.start()
    try:
        assert sched.drain(timeout=120)
    finally:
        sched.shutdown()
    assert sched.gangs_run == 1
    vols = []
    for job in jobs:
        assert job.state is JobState.DONE, job.snapshot()
        vols.append(job.runner.transport.read(job.runner.datasets["recon"]))
    for job, vol in zip(jobs, vols):
        (dev,) = _named(job.trace, "transport.to_device")
        (host,) = _named(job.trace, "transport.to_host")
        assert host.attrs["bytes"] == vol.nbytes
        assert len(_named(job.trace, "runner.prepare")) == 1
        (proc,) = _named(job.trace, "plugin.dark_flat_correction.process")
        # the member's raw went to the card inside the gang's step
        assert proc.start <= dev.start <= dev.end <= proc.end
    # the steps built for the gang land on its first member's trace,
    # tagged with the gang's size
    head = _named(jobs[0].trace, "compile")
    assert head and all(s.attrs["gang"] == 4 for s in head)
    assert not any(_named(j.trace, "compile") for j in jobs[1:])


def test_use_trace_tags_what_is_recorded_through_the_current_trace():
    tr = Trace()
    with use_trace(tr, gang=3):
        current_trace().record("compile", 1.0, 2.0, attrs={"kind": "x"})
        with current_trace().span("kernels.load", library="k"):
            pass
        assert current_trace().trace_id == tr.trace_id
    tr.record("queue.wait", 0.0, 1.0)
    got = {s.name: s.attrs for s in tr.spans()}
    assert got == {"compile": {"gang": 3, "kind": "x"},
                   "kernels.load": {"gang": 3, "library": "k"},
                   "queue.wait": {}}
    assert current_trace() is None
