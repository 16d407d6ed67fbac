"""The port's parameter sweeps (``repro_torch.service.sweep``) against
tests/test_sweep.py, on ``CudaTransport("cpu")`` at 20 x 20 chains: its
local-mode cases, and its broker cases with an in-process
``PipelineWorker`` that leases a sweep as one gang.

A sweep over N values of one tunable param expands into N variant jobs
with one chain signature, admitted atomically, so the gang path runs
each plugin step as ONE call for all variants: one build per plugin
step, and a stacked ``(N, ...)`` result bit-identical to N solo jobs.
Each variant also agrees with the JAX package's serial run of the same
spec within the chain's bound (rtol 1e-3, atol 1e-4), and the metrics,
scored with torch where the volume lies, match the JAX package's numpy
scores.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import repro.core as R
import repro.service as JS
import repro.service.sweep as JSW

from repro_torch.core import CudaTransport, PluginRunner
from repro_torch.service import (CompileCache, JobQueue, PipelineClient,
                                 PipelineService, PipelineWorker,
                                 ServiceError,
                                 chain_signature, expand_sweep,
                                 parse_sweep_block, to_spec)
from repro_torch.service import sweep as SW
from repro_torch.tomo import standard_chain

N = dict(n_det=20, n_angles=20, n_rows=1)
TOL = dict(rtol=1e-3, atol=1e-4)
CUTOFFS = [0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
WAIT_S = 120


def _chain(seed=0, **over):
    return standard_chain(**{**N, **over}, seed=seed, device="cpu")


def _axis(values=CUTOFFS, plugin="sinogram_filter", param="cutoff"):
    return {"plugin": plugin, "param": param, "values": list(values)}


def _with(pl, plugin, **params):
    for e in pl.entries:
        if e.cls.name == plugin:
            e.params.update(params)
    return pl


def _jax_recon(pl) -> np.ndarray:
    """The JAX package's serial run of the same spec."""
    r = R.PluginRunner(JS.from_spec(to_spec(pl)), R.InMemoryTransport())
    return np.asarray(r.transport.read(r.run()["recon"]))


@contextlib.contextmanager
def _served(start=True, **kw):
    svc = PipelineService(device="cpu", **kw)
    host, port = svc.serve(port=0)
    if not start:
        svc.scheduler.shutdown()
    try:
        yield svc, PipelineClient(f"http://{host}:{port}", timeout=60.0)
    finally:
        svc.stop()


# ==================================================== expansion (units)
def test_variants_share_one_chain_signature():
    axes = parse_sweep_block(_axis(), _chain())
    variants = expand_sweep(_chain(), axes)
    assert len(variants) == len(CUTOFFS)
    sigs = {chain_signature(pl) for _, pl in variants}
    assert sigs == {chain_signature(_chain())}
    for (combo, pl), want in zip(variants, CUTOFFS):
        assert combo == (want,)
        (sf,) = [e for e in pl.entries if e.cls.name == "sinogram_filter"]
        assert sf.params["cutoff"] == want


def test_two_param_grid_expands_in_c_order():
    pl = _chain(ring=True)
    axes = parse_sweep_block(
        [_axis([0.5, 1.0]), _axis([0.0, 1.0, 2.0], "ring_removal",
                                  "strength")], pl)
    variants = expand_sweep(pl, axes)
    assert [c for c, _ in variants] == [
        (0.5, 0.0), (0.5, 1.0), (0.5, 2.0),
        (1.0, 0.0), (1.0, 1.0), (1.0, 2.0)]
    assert len({chain_signature(p) for _, p in variants}) == 1
    # the JAX package expands the same grid in the same order
    jpl = JS.from_spec(to_spec(pl))
    jvariants = JSW.expand_sweep(jpl, JSW.parse_sweep_block(
        [a.spec() for a in axes], jpl))
    assert [c for c, _ in jvariants] == [c for c, _ in variants]


def test_queue_submit_many_is_atomic():
    q = JobQueue(max_pending=3)
    q.submit(_chain(seed=0))
    with pytest.raises(Exception) as ei:      # QueueFull
        q.submit_many([_chain(seed=s) for s in range(3)])
    assert "max_pending" in str(ei.value)
    assert q.pending() == 1
    q2 = JobQueue()
    q2.submit(_chain(seed=0), job_id="dup")
    with pytest.raises(ValueError):
        q2.submit_many([_chain(seed=1), _chain(seed=2)],
                       job_ids=["fresh", "dup"])
    assert q2.pending() == 1


@pytest.mark.parametrize("metric", sorted(SW.METRICS))
def test_metrics_score_where_the_volume_lies_as_numpy_does(metric):
    """Each metric, computed with torch on the result's tensor, gives
    the JAX package's numpy score (float64 both, sums in another order)."""
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(3, 24, 24)).astype(np.float32)
    vol[0, :4] = vol[0, 0, 0]                # values on the bin edges
    got = SW.METRICS[metric].fn(torch.from_numpy(vol))
    want = JSW.METRICS[metric].fn(vol)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert SW.METRICS[metric].higher_is_better == \
        JSW.METRICS[metric].higher_is_better
    flat = np.full((2, 3), 7.0, np.float32)  # one value: numpy's +-0.5 bins
    assert SW.METRICS[metric].fn(torch.from_numpy(flat)) == \
        pytest.approx(JSW.METRICS[metric].fn(flat), abs=1e-12)


# ============================================== acceptance path (local)
@pytest.fixture
def gang_service():
    """Gang-batching service on the CPU: one shared CompileCache, a
    batch_max wide enough for a 7-point sweep."""
    cache = CompileCache()
    with _served(n_workers=2, compile_cache=cache, batch_identical=True,
                 batch_max=8) as (svc, client):
        yield svc, client, cache


def test_sweep_bit_identical_one_compile_per_plugin(gang_service):
    """POST /sweeps with 7 values of one param: stacked (7, ...) result
    bit-identical to 7 solo jobs, exactly one build per plugin step, one
    gang and no fallback; each variant within the chain's bound of the
    JAX package's run."""
    svc, client, cache = gang_service
    reply = client.sweep(_chain(seed=3), _axis(), metric="sharpness")
    assert reply["n_variants"] == 7 and reply["shape"] == [7]
    snap = client.wait_sweep(reply["sweep_id"], timeout=WAIT_S)
    assert snap["state"] == "done", snap
    st = cache.stats()
    n_steps = snap["variants"][0]["n_plugins"]
    assert st["misses"] == n_steps == 4, st
    stats = client.stats()
    assert stats["gangs_run"] == 1 and stats["gang_fallbacks"] == 0
    stacked = client.sweep_result(reply["sweep_id"])
    assert stacked.shape == (7, 1, 20, 20)
    for k, cutoff in enumerate(CUTOFFS):
        pl = _with(_chain(seed=3), "sinogram_filter", cutoff=cutoff)
        jid = client.submit(pl)
        assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
        np.testing.assert_array_equal(stacked[k], client.result(jid))
        np.testing.assert_allclose(stacked[k], _jax_recon(pl), **TOL)
    best = snap["best_variant"]
    assert best["index"] in range(7)
    assert set(best["values"]) == {"sinogram_filter.cutoff"}
    scores = [v["score"] for v in snap["variants"]]
    assert best["score"] == max(scores)
    want = [JSW.METRICS["sharpness"].fn(stacked[k]) for k in range(7)]
    np.testing.assert_allclose(scores, want, rtol=1e-12)


def test_sweep_two_param_grid_result_layout(gang_service):
    svc, client, _ = gang_service
    reply = client.sweep(
        _chain(seed=1),
        [_axis([0.5, 1.0]), _axis([0.0, 1.0], "ring_removal", "strength")])
    snap = client.wait_sweep(reply["sweep_id"], timeout=WAIT_S)
    assert snap["state"] == "done", snap
    assert client.stats()["gang_fallbacks"] == 0
    stacked = client.sweep_result(reply["sweep_id"])
    assert stacked.shape[:2] == (2, 2)
    for k, v in enumerate(snap["variants"]):
        i, j = divmod(k, 2)
        np.testing.assert_array_equal(stacked[i, j],
                                      client.result(v["job_id"]))
    # grid corner: (cutoff=1.0, strength=1.0) == the plain chain
    r = PluginRunner(_chain(seed=1), CudaTransport("cpu"))
    np.testing.assert_array_equal(stacked[1, 1],
                                  r.transport.read(r.run()["recon"]))
    np.testing.assert_allclose(
        stacked[0, 0], _jax_recon(_with(_with(
            _chain(seed=1), "sinogram_filter", cutoff=0.5),
            "ring_removal", strength=0.0)), **TOL)


@pytest.mark.parametrize("plugin,param,values", [
    ("sinogram_filter", "cutoff", [1.0, 0.7, 0.4]),
    ("ring_removal", "strength", [0.0, 0.5, 2.0]),
    ("paganin_filter", "tau", [1.0, 10.0, 40.0]),
])
def test_each_tunable_gangs_as_one_call_per_step(plugin, param, values):
    """Each of the three tunables varies a per-member constant that its
    plugin's batched hook takes: the sweep's steps all run as one call
    (no fallback), and every variant equals its solo run bit for bit."""
    chain = _chain(seed=2, paganin=True)
    with _served(n_workers=1, batch_identical=True,
                 batch_max=8) as (svc, client):
        reply = client.sweep(chain, _axis(values, plugin, param))
        snap = client.wait_sweep(reply["sweep_id"], timeout=WAIT_S)
        assert snap["state"] == "done", snap
        stats = client.stats()
        assert stats["gangs_run"] == 1 and stats["gang_fallbacks"] == 0
        stacked = client.sweep_result(reply["sweep_id"])
    for k, v in enumerate(values):
        pl = _with(_chain(seed=2, paganin=True), plugin, **{param: v})
        r = PluginRunner(pl, CudaTransport("cpu"))
        np.testing.assert_array_equal(stacked[k],
                                      r.transport.read(r.run()["recon"]))
        np.testing.assert_allclose(stacked[k], _jax_recon(pl), **TOL)


# ======================================================== error contract
@pytest.fixture
def idle_service():
    """Service whose scheduler is stopped — jobs stay queued."""
    with _served(start=False, n_workers=1, max_pending=8,
                 max_sweep_variants=16) as pair:
        yield pair


def test_sweep_validation_is_400(idle_service):
    _, client = idle_service
    cases = [
        ({"plugin": "sinogram_filter", "param": "kind",
          "values": ["shepp", "hann"]}, "not sweepable"),
        ({"plugin": "fbp_recon", "param": "warp", "values": [1]},
         "no parameter"),
        ({"plugin": "ghost_plugin", "param": "x", "values": [1]},
         "matches 0 entries"),
        ({"plugin_index": 99, "param": "cutoff", "values": [1]},
         "plugin_index"),
        ({"plugin": "sinogram_filter", "param": "cutoff", "values": []},
         "non-empty"),
        ([_axis([0.5]), _axis([0.6])], "distinct"),
        ([{"plugin": "sinogram_filter", "param": "cutoff",
           "values": [0.1 * i]} for i in range(3)], "at most 2"),
        # where a job computes is the service's choice, not a sweep axis
        ({"plugin": "synthetic_tomo_loader", "param": "device",
          "values": ["cpu"]}, "not sweepable"),
    ]
    for sweep, needle in cases:
        with pytest.raises(ServiceError) as ei:
            client.sweep(_chain(), sweep)
        assert ei.value.status == 400, sweep
        assert needle in ei.value.message, (sweep, ei.value.message)
    with pytest.raises(ServiceError) as ei:
        client.sweep(_chain(), _axis([0.5]), metric="vibes")
    assert ei.value.status == 400 and "vibes" in ei.value.message
    with pytest.raises(ServiceError) as ei:
        client.sweep(_chain(), [_axis([0.1] * 5),
                                _axis([0.1] * 5, "ring_removal",
                                      "strength")])
    assert ei.value.status == 400 and "max_variants" in ei.value.message


def test_sweep_atomic_admission_is_429(idle_service):
    svc, client = idle_service                # max_pending=8
    client.submit(_chain(seed=0))
    client.submit(_chain(seed=1))
    before = len(client.jobs())
    with pytest.raises(ServiceError) as ei:
        client.sweep(_chain(seed=2), _axis())  # 7 variants, 2+7 > 8
    assert ei.value.status == 429
    assert len(client.jobs()) == before
    assert svc.queue.pending() == 2


def test_sweep_lifecycle_404_409(idle_service):
    _, client = idle_service
    for call in (lambda: client.sweep_status("ghost"),
                 lambda: client.sweep_result("ghost"),
                 lambda: client.cancel_sweep("ghost")):
        with pytest.raises(ServiceError) as ei:
            call()
        assert ei.value.status == 404
    reply = client.sweep(_chain(seed=3), _axis([0.5, 1.0]),
                         sweep_id="tune-1")
    assert reply["sweep_id"] == "tune-1"
    assert reply["job_ids"] == ["tune-1/v000", "tune-1/v001"]
    with pytest.raises(ServiceError) as ei:
        client.sweep_result("tune-1")
    assert ei.value.status == 409
    with pytest.raises(ServiceError) as ei:
        client.sweep(_chain(seed=4), _axis([0.5]), sweep_id="tune-1")
    assert ei.value.status == 409


def test_sweep_cancel_cancels_all_variants(idle_service):
    _, client = idle_service
    reply = client.sweep(_chain(seed=1), _axis([0.4, 0.7, 1.0]))
    out = client.cancel_sweep(reply["sweep_id"])
    assert sorted(out["cancelled"]) == sorted(reply["job_ids"])
    snap = client.sweep_status(reply["sweep_id"])
    assert snap["state"] == "cancelled" and snap["all_terminal"]
    assert {v["state"] for v in snap["variants"]} == {"cancelled"}
    assert any(s["sweep_id"] == reply["sweep_id"]
               for s in client.sweeps())
    assert client.cancel_sweep(reply["sweep_id"])["cancelled"] == []


# ====================================================== workers_remote
def test_sweep_remote_gang_worker_bit_identical():
    """The same acceptance path through the broker: one gang worker
    (max_batch=8) leases the whole sweep and runs it through
    ``run_plugin_batch`` — one build per plugin step in ITS cache, no
    fallback — and the stacked result is bit-identical to solo runs."""
    cache = CompileCache()
    with _served(workers_remote=True, lease_ttl=15.0) as (svc, client):
        reply = client.sweep(_chain(seed=5), _axis(), metric="sharpness")
        w = PipelineWorker(
            client.base_url, device="cpu", worker_id="gang-w", max_batch=8,
            poll=0.01, heartbeat=1.0, compile_cache=cache)
        w.register()
        assert w.run_once() is True
        snap = client.wait_sweep(reply["sweep_id"], timeout=WAIT_S)
        assert snap["state"] == "done", snap
        assert w.jobs_done == 7 and w.gang_fallbacks == 0
        assert cache.stats()["misses"] == 4   # one build per plugin step
        stacked = client.sweep_result(reply["sweep_id"])
        assert stacked.shape == (7, 1, 20, 20)
        for k, cutoff in enumerate(CUTOFFS):
            r = PluginRunner(_with(_chain(seed=5), "sinogram_filter",
                                   cutoff=cutoff), CudaTransport("cpu"))
            np.testing.assert_array_equal(
                stacked[k], r.transport.read(r.run()["recon"]))
        assert snap["best_variant"] is not None
        # every variant's process spans carry the gang's size
        job0 = reply["job_ids"][0]
        gangs = {s["attrs"].get("gang") for s in client.trace(job0)["spans"]
                 if s.get("attrs", {}).get("phase") == "process"}
        assert gangs == {7}


def test_no_sweeps_worker_never_leases_variants():
    """sweep-aware capability filtering: a worker registered with
    sweeps=False leases plain jobs but never sweep variants."""
    with _served(workers_remote=True, lease_ttl=5.0) as (svc, client):
        client.register_worker(worker_id="plain-w", sweeps=False)
        client.sweep(_chain(seed=1), _axis([0.5, 1.0]))
        assert client.lease("plain-w", max_jobs=4) == []
        jid = client.submit(_chain(seed=2))
        assert [d["job_id"] for d in client.lease("plain-w")] == [jid]
        # an unrestricted worker drains the sweep (as ONE gang lease)
        client.register_worker(worker_id="full-w", max_batch=4)
        got = client.lease("full-w", max_jobs=4)
        assert len(got) == 2


def test_broker_spool_gc_on_history_eviction():
    """Uploaded .npy results die with their job: when max_history
    evicts a terminal job, its result spool directory is deleted."""
    with _served(workers_remote=True, lease_ttl=15.0,
                 max_history=1) as (svc, client):
        w = PipelineWorker(client.base_url, device="cpu", worker_id="w0",
                           poll=0.01)
        w.register()
        ids = []
        for s in range(3):
            jid = client.submit(_chain(seed=s))
            ids.append(jid)
            assert w.run_once() is True
            assert client.status(jid)["state"] == "done"
        spool = lambda jid: os.path.join(          # noqa: E731
            svc.broker.results_dir, jid.replace(os.sep, "_"))
        assert os.path.exists(spool(ids[-1]))
        # pruning runs at submit: this pushes the 2 oldest out
        jid = client.submit(_chain(seed=9))
        assert w.run_once() is True
        assert not os.path.exists(spool(ids[0])), "spool leaked"
        assert not os.path.exists(spool(ids[1])), "spool leaked"
        # the freshest result is still retained and streamable
        r = PluginRunner(_chain(seed=9), CudaTransport("cpu"))
        np.testing.assert_array_equal(client.result(jid),
                                      r.transport.read(r.run()["recon"]))
        with pytest.raises(ServiceError) as ei:
            client.result(ids[0])
        assert ei.value.status == 404
