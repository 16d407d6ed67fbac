"""The port's workflow DAGs (``repro_torch.service.workflow``) against
tests/test_workflow.py (its queue-level, envelope and in-process
scheduler cases), on ``CudaTransport("cpu")``.

Queue layer: ``after=[...]`` pop gating, failure / cancel / eviction
cascades with machine-readable ``cancel_reason``, atomic ``submit_many``
and exactly-once terminal hooks.  Envelope layer: cyclic, dangling and
malformed spec-v3 envelopes rejected with 400, nothing enqueued.
Execution: random DAGs run in topological order with downstream inputs
bit-identical to the upstream outputs they reference, which the
scheduler hands over where the upstream left them (no copy), and the
3-stage recon -> downsample -> quantify workflow agrees with the JAX
package's stages within the chain's bound (rtol 1e-3, atol 1e-4).
Broker mode (tests/test_workflow.py's broker cases): random DAGs run
topologically through a pull-based worker, a SIGKILLed downstream node
resumes without re-running its upstream, and the 3-stage workflow runs
over two worker processes.
"""
import contextlib
import importlib
import os
import random
import signal
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro.service as JS

from repro_torch.core.patterns import PROJECTION
from repro_torch.core.plugin import BaseFilter
from repro_torch.service import (JobQueue, PipelineClient, PipelineService,
                                 PipelineWorker, ServiceError,
                                 WorkflowError, WorkflowManager, from_spec,
                                 toposort)
from repro_torch.service.worker import spawn_local_workers
from repro_torch.service import wire
from repro_torch.service.job import JobState

TOL = dict(rtol=1e-3, atol=1e-4)
WAIT_S = 120
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


class FailingPlugin(BaseFilter):
    """Raises on the first frame — drives a workflow node to FAILED."""

    name = "failing_plugin"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"message": "injected failure"}

    def process_frames(self, frames):
        raise RuntimeError(self.params["message"])


def _recon_spec(seed=0, n_det=16, n_angles=12, n_rows=2, fail=False):
    plugins = [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": n_det, "n_angles": n_angles,
                    "n_rows": n_rows, "seed": seed},
         "out_datasets": ["tomo"]},
    ]
    if fail:
        plugins.append({"plugin": "failing_plugin",
                        "in_datasets": ["tomo"], "out_datasets": ["tomo"]})
    plugins += [
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]
    return {"version": 1, "plugins": plugins}


def _passthrough_spec(parent, dataset, delay=0.0):
    """A downstream chain re-saving its parent's output as ``vol``;
    ``delay`` > 0 slows it (``slow_volume_identity``) so its worker can
    be killed mid-node."""
    plugins = [
        {"plugin": "upstream_loader",
         "params": {"data": {"from_job": parent, "dataset": dataset}},
         "out_datasets": ["vol"]}]
    if delay:
        plugins.append({"plugin": "slow_volume_identity",
                        "params": {"delay": delay},
                        "in_datasets": ["vol"], "out_datasets": ["vol"]})
    plugins.append({"plugin": "hdf5_saver", "in_datasets": ["vol"]})
    return {"version": 1, "plugins": plugins}


def _downsample_spec(parent, dataset="recon", factor=2):
    return {"version": 1, "plugins": [
        {"plugin": "upstream_loader",
         "params": {"data": {"from_job": parent, "dataset": dataset}},
         "out_datasets": ["vol"]},
        {"plugin": "downsample", "params": {"factor": factor},
         "in_datasets": ["vol"], "out_datasets": ["small"]},
        {"plugin": "hdf5_saver", "in_datasets": ["small"]},
    ]}


def _quantify_spec(parent, dataset="small"):
    return {"version": 1, "plugins": [
        {"plugin": "upstream_loader",
         "params": {"data": {"from_job": parent, "dataset": dataset}},
         "out_datasets": ["vol"]},
        {"plugin": "quantify",
         "in_datasets": ["vol"], "out_datasets": ["stats"]},
        {"plugin": "hdf5_saver", "in_datasets": ["stats"]},
    ]}


def _pl(**kw):
    return from_spec(_recon_spec(**kw), device="cpu")


def _finish(q, job, state=JobState.DONE):
    """Drive a popped job terminal the way a scheduler would."""
    job.state = state
    job.finished_at = time.time()
    q.notify_terminal(job)


@contextlib.contextmanager
def _service(**kw):
    svc = PipelineService(device="cpu", **kw)
    try:
        yield svc
    finally:
        svc.stop()


def _wait(group):
    deadline = time.time() + WAIT_S
    while not group.all_terminal():
        assert time.time() < deadline, group.snapshot()
        time.sleep(0.01)


# ===================================================== queue-level DAG
def test_fan_out_fan_in_pop_gating():
    q = JobQueue()
    a = q.submit(_pl(), job_id="a")
    q.submit(_pl(), job_id="b", after=["a"])
    q.submit(_pl(), job_id="c", after=["a"])
    d = q.submit(_pl(), job_id="d", after=["b", "c"])
    assert q.get(timeout=0.1).job_id == "a"
    assert q.get(timeout=0.05) is None
    assert sorted(d.snapshot()["waiting_on"]) == ["b", "c"]
    _finish(q, a)
    got = {q.get(timeout=0.1).job_id, q.get(timeout=0.1).job_id}
    assert got == {"b", "c"}
    assert q.get(timeout=0.05) is None
    _finish(q, q.job("b"))
    assert q.get(timeout=0.05) is None
    assert d.snapshot()["waiting_on"] == ["c"]
    _finish(q, q.job("c"))
    assert q.get(timeout=0.1).job_id == "d"


def test_upstream_failure_cascades_with_reasons():
    q = JobQueue()
    a = q.submit(_pl(), job_id="a")
    b = q.submit(_pl(), job_id="b", after=["a"])
    c = q.submit(_pl(), job_id="c", after=["b"])
    assert q.get(timeout=0.1) is a
    _finish(q, a, JobState.FAILED)
    assert b.state is JobState.CANCELLED
    assert b.snapshot()["cancel_reason"] == "upstream_failed"
    assert "a" in b.snapshot()["error"]
    assert c.state is JobState.CANCELLED
    assert c.snapshot()["cancel_reason"] == "upstream_cancelled"


def test_user_cancel_cascades():
    q = JobQueue()
    a = q.submit(_pl(), job_id="a")
    b = q.submit(_pl(), job_id="b", after=["a"])
    assert q.cancel("a") is True
    assert a.snapshot()["cancel_reason"] == "user"
    assert b.state is JobState.CANCELLED
    assert b.snapshot()["cancel_reason"] == "upstream_cancelled"


def test_admission_against_terminal_upstream():
    q = JobQueue()
    a = q.submit(_pl(), job_id="a")
    assert q.get(timeout=0.1) is a
    _finish(q, a, JobState.FAILED)
    b = q.submit(_pl(), job_id="b", after=["a"])
    assert b.state is JobState.CANCELLED
    assert b.snapshot()["cancel_reason"] == "upstream_failed"
    c = q.submit(_pl(), job_id="c")
    assert q.get(timeout=0.1) is c
    _finish(q, c)
    d = q.submit(_pl(), job_id="d", after=["c"])
    assert q.get(timeout=0.1) is d
    with pytest.raises(ValueError, match="unknown upstream"):
        q.submit(_pl(), job_id="e", after=["ghost"])
    with pytest.raises(ValueError, match="itself"):
        q.submit(_pl(), job_id="f", after=["f"])


def test_eviction_of_data_dep_cancels_downstream():
    q = JobQueue(max_history=1)
    up = q.submit(_pl(), job_id="up")
    assert q.get(timeout=0.1) is up
    _finish(q, up)
    down = q.submit(_pl(), job_id="down", data_deps=["up"])
    f1 = q.submit(_pl(), job_id="f1", priority=1)
    assert q.get(timeout=0.1) is f1
    _finish(q, f1)
    q.submit(_pl(), job_id="f2")                 # triggers the prune
    with pytest.raises(KeyError):
        q.job("up")
    assert down.state is JobState.CANCELLED
    assert down.snapshot()["cancel_reason"] == "upstream_evicted"
    assert "evicted" in down.snapshot()["error"]


def test_terminal_hooks_fire_exactly_once_per_cascaded_job():
    q = JobQueue()
    fired: dict[str, int] = {}
    q.add_terminal_hook(
        lambda j: fired.__setitem__(j.job_id, fired.get(j.job_id, 0) + 1))
    a = q.submit(_pl(), job_id="a")
    q.submit(_pl(), job_id="b", after=["a"])
    q.submit(_pl(), job_id="c", after=["b"])
    q.submit(_pl(), job_id="d", after=["b"])
    assert q.get(timeout=0.1) is a
    _finish(q, a, JobState.FAILED)
    q.notify_terminal(a)
    assert fired == {"b": 1, "c": 1, "d": 1}


def test_submit_many_is_atomic():
    q = JobQueue()
    with pytest.raises(ValueError, match="unknown upstream"):
        q.submit_many([_pl(), _pl()], job_ids=["x", "y"],
                      afters=[[], ["ghost"]])
    assert q.snapshot() == []
    jobs = q.submit_many([_pl(), _pl()], job_ids=["y", "x"],
                         afters=[["x"], []])
    assert [j.job_id for j in jobs] == ["y", "x"]
    assert q.get(timeout=0.1).job_id == "x"


# ============================================== envelope validation
def test_toposort_orders_and_rejects_cycles():
    assert toposort({"a": [], "b": ["a"], "c": ["a", "b"]}) == \
        ["a", "b", "c"]
    with pytest.raises(WorkflowError, match="cycle"):
        toposort({"a": ["b"], "b": ["a"]})
    with pytest.raises(WorkflowError, match="cycle"):
        toposort({"a": ["a"]})


def test_http_rejects_bad_envelopes_atomically():
    """Every bad envelope is 400 at ``POST /workflows`` from the port's
    service, as from the JAX package's, and nothing is enqueued."""
    r = _recon_spec()
    bad = [
        {"version": 3, "workflow": {
            "a": {"process_list": r, "after": ["b"]},
            "b": {"process_list": r, "after": ["a"]}}},
        {"version": 3, "workflow": {
            "a": {"process_list": r, "after": ["ghost"]}}},
        {"version": 3, "workflow": {
            "a": {"process_list": r},
            "b": {"process_list": _passthrough_spec("ghost", "recon")}}},
        {"version": 3, "workflow": {
            "a": {"process_list": r, "after": ["a"]}}},
        {"version": 3, "workflow": {"bad/name": {"process_list": r}}},
        {"version": 1, "workflow": {"a": {"process_list": r}}},
        {"version": 3, "workflow": {}},
        {"version": 3, "workflow": {
            "a": {"process_list": {"version": 1, "plugins": [
                {"plugin": "no_such_plugin"}]}}}},
    ]
    for svc in (PipelineService(device="cpu"), JS.PipelineService()):
        host, port = svc.serve(port=0)
        svc.scheduler.shutdown()                 # nothing dispatches
        client = PipelineClient(f"http://{host}:{port}", timeout=30.0)
        try:
            for env in bad:
                with pytest.raises(ServiceError) as ei:
                    client._request("POST", "/workflows", env)
                assert ei.value.status == 400, (env, ei.value)
            assert client.jobs() == []
            ok = {"version": 3, "workflow": {"a": {"process_list": r}},
                  "workflow_id": "wf-dup"}
            assert client._request("POST", "/workflows", ok)["n_nodes"] == 1
            with pytest.raises(ServiceError) as ei:
                client._request("POST", "/workflows", ok)
            assert ei.value.status == 409
            assert len(client.jobs()) == 1
            with pytest.raises(ServiceError) as ei:
                client.workflow_status("no-such-wf")
            assert ei.value.status == 404
        finally:
            svc.stop()


# ======================================== property: random DAG shapes
try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                          # pragma: no cover
    HAVE_HYPOTHESIS = False


def _random_dag(rng, max_nodes=12):
    """A random DAG ``{node: [upstream nodes]}``: node i depends only on
    earlier nodes."""
    n = rng.randint(2, max_nodes)
    edges = {}
    for i in range(n):
        k = rng.randint(0, min(i, 3))
        ups = sorted(rng.sample(range(i), k)) if k else []
        edges[f"n{i}"] = [f"n{u}" for u in ups]
    return edges


if HAVE_HYPOTHESIS:
    @st.composite
    def _dags(draw, max_nodes=12):
        n = draw(st.integers(min_value=2, max_value=max_nodes))
        edges = {}
        for i in range(n):
            ups = draw(st.lists(st.integers(0, i - 1), unique=True,
                                max_size=min(i, 3))) if i else []
            edges[f"n{i}"] = [f"n{u}" for u in sorted(ups)]
        return edges


def _property(max_examples, max_nodes):
    """``@given`` random DAGs under hypothesis, else a seeded
    ``parametrize`` sweep of the same shapes."""
    if HAVE_HYPOTHESIS:
        def deco(fn):
            return settings(
                max_examples=max_examples, deadline=None,
                suppress_health_check=[HealthCheck.too_slow],
            )(given(edges=_dags(max_nodes=max_nodes))(fn))
        return deco

    def deco(fn):
        shapes = [_random_dag(random.Random(seed), max_nodes)
                  for seed in range(max_examples)]
        return pytest.mark.parametrize("edges", shapes)(fn)
    return deco


def _dag_envelope(edges, workflow_id):
    """Roots are tiny recon chains (seed = node index); dependent nodes
    consume their FIRST parent's output and declare the rest via
    ``after``."""
    nodes, out_name = {}, {}
    for i, (name, ups) in enumerate(edges.items()):
        if not ups:
            nodes[name] = {"process_list": _recon_spec(seed=i)}
            out_name[name] = "recon"
        else:
            nodes[name] = {
                "process_list": _passthrough_spec(ups[0], out_name[ups[0]]),
                "after": list(ups)}
            out_name[name] = "vol"
    return ({"version": 3, "workflow": nodes,
             "workflow_id": workflow_id}, out_name)


def _read(svc, workflow_id, node, dataset):
    ds, transport = svc.result_dataset(f"{workflow_id}/{node}", dataset)
    return transport.read(ds)


@_property(max_examples=6, max_nodes=12)
def test_random_dags_run_topologically_scheduler(edges):
    """Any random DAG executes every node in topological order, with
    downstream inputs bit-identical to the upstream outputs they
    reference."""
    env, out_name = _dag_envelope(edges, "wf-prop")
    with _service(n_workers=2) as svc:
        group = svc.submit_workflow(env)
        svc.scheduler.start()
        _wait(group)
        snap = group.snapshot()
        assert snap["state"] == "done", snap
        jobs = snap["node_jobs"]
        for node, ups in snap["edges"].items():
            for up in ups:
                assert jobs[up]["finished_at"] <= jobs[node]["started_at"]
            if ups:
                np.testing.assert_array_equal(
                    _read(svc, "wf-prop", node, "vol"),
                    _read(svc, "wf-prop", ups[0], out_name[ups[0]]))


@_property(max_examples=4, max_nodes=6)
def test_random_dags_run_topologically_broker(edges):
    """The same topological-order guarantee when dependency-aware
    leasing hands nodes to a pull-based worker, with upstream outputs
    fetched over the wire; results are the broker's ``.npy`` spool."""
    env, out_name = _dag_envelope(edges, "wf-prop-b")
    with _service(workers_remote=True, lease_ttl=10.0,
                  sweep_interval=0.2) as svc:
        host, port = svc.serve(port=0)
        group = svc.submit_workflow(env)
        w = PipelineWorker(f"http://{host}:{port}", device="cpu",
                           worker_id="pw", poll=0.01)
        w.register()
        deadline = time.time() + WAIT_S
        while not group.all_terminal():
            assert time.time() < deadline, group.snapshot()
            if not w.run_once():
                time.sleep(0.01)
        snap = group.snapshot()
        assert snap["state"] == "done", snap
        jobs = snap["node_jobs"]
        for node, ups in snap["edges"].items():
            for up in ups:
                assert jobs[up]["finished_at"] <= jobs[node]["started_at"]
            if ups:
                got = svc.result_file(f"wf-prop-b/{node}", "vol")
                want = svc.result_file(f"wf-prop-b/{ups[0]}",
                                       out_name[ups[0]])
                np.testing.assert_array_equal(np.load(got[1]),
                                              np.load(want[1]))


@_property(max_examples=20, max_nodes=8)
def test_random_broken_dags_rejected_atomically(edges):
    names = list(edges)
    env, _ = _dag_envelope(edges, "wf-bad")
    env["workflow"][names[0]].setdefault("after", []).append(names[-1])
    env["workflow"][names[-1]].setdefault("after", []).append(names[0])
    q = JobQueue()
    with pytest.raises(WorkflowError):
        WorkflowManager(q).submit(env)
    assert q.snapshot() == []
    for victim in names:
        env, _ = _dag_envelope(edges, "wf-bad")
        env["workflow"][victim].setdefault("after", []).append("ghost")
        q = JobQueue()
        with pytest.raises(WorkflowError):
            WorkflowManager(q).submit(env)
        assert q.snapshot() == []


# ========================================= failure-propagation matrix
def test_failure_propagation_matrix(monkeypatch):
    # registered for this test only: the wire registry is the process's
    monkeypatch.setitem(wire._REGISTRY, FailingPlugin.name, FailingPlugin)
    with _service() as svc:                      # upstream failed
        group = svc.submit_workflow({"version": 3, "workflow": {
            "up": {"process_list": _recon_spec(fail=True)},
            "down": {"process_list": _passthrough_spec("up", "recon")},
        }, "workflow_id": "wf-fail"})
        svc.scheduler.start()
        _wait(group)
        snap = group.snapshot()
        assert snap["state"] == "failed", snap
        assert snap["node_jobs"]["up"]["state"] == "failed"
        down = snap["node_jobs"]["down"]
        assert down["state"] == "cancelled"
        assert down["cancel_reason"] == "upstream_failed"
        assert "up" in down["error"]
        assert svc.metrics.counter("jobs.cancelled").value == 1
        assert svc.metrics.counter("jobs.failed").value == 1
    with _service() as svc:                      # upstream cancelled
        group = svc.submit_workflow({"version": 3, "workflow": {
            "up": {"process_list": _recon_spec()},
            "down": {"process_list": _passthrough_spec("up", "recon")},
        }, "workflow_id": "wf-cancel"})
        assert svc.cancel("wf-cancel/up")["cancelled"] is True
        snap = group.snapshot()
        assert snap["node_jobs"]["up"]["cancel_reason"] == "user"
        down = snap["node_jobs"]["down"]
        assert down["state"] == "cancelled"
        assert down["cancel_reason"] == "upstream_cancelled"
        assert svc.metrics.counter("jobs.cancelled").value == 2
    with _service(max_history=1) as svc:         # upstream evicted
        q = svc.queue
        up = q.submit(_pl(), job_id="up")
        assert q.get(timeout=0.1) is up
        _finish(q, up)
        down = q.submit(_pl(), job_id="down", data_deps=["up"])
        f1 = q.submit(_pl(), job_id="f1", priority=1)
        assert q.get(timeout=0.1) is f1
        _finish(q, f1)
        q.submit(_pl(), job_id="f2")
        assert down.state is JobState.CANCELLED
        assert down.snapshot()["cancel_reason"] == "upstream_evicted"
        assert svc.metrics.counter("jobs.cancelled").value == 1


# ==================================== 3 stages over HTTP, local mode
def _jax_stage(spec, data=None):
    """One stage run by the JAX package (an upstream_loader given
    ``data``)."""
    pl = JS.from_spec(spec)
    if data is not None:
        pl.entries[0].params["data"] = data
    r = R.PluginRunner(pl, R.InMemoryTransport())
    out = r.run()
    name = r.result_names()[0]
    return np.asarray(r.transport.read(out[name]))


def test_three_stage_workflow_over_http():
    """recon -> downsample -> quantify as ONE ``POST /workflows``: per-node
    status, a linked trace, each downstream node fed its upstream's
    tensor itself (no copy), and every stage within the chain's bound of
    the JAX package's stages."""
    nodes = {"recon": {"process_list": _recon_spec(seed=4)},
             "downsample": {"process_list": _downsample_spec("recon")},
             "quantify": {"process_list": _quantify_spec("downsample"),
                          "after": ["downsample"]}}
    with _service(n_workers=2) as svc:
        host, port = svc.serve(port=0)
        client = PipelineClient(f"http://{host}:{port}", timeout=30.0)
        reply = client.workflow(nodes, workflow_id="wf3")
        assert reply["nodes"] == ["recon", "downsample", "quantify"]
        snap = client.wait_workflow("wf3", timeout=WAIT_S)
        assert snap["state"] == "done", snap
        trace = client.workflow_trace("wf3")
        assert set(trace["nodes"]) == {"recon", "downsample", "quantify"}
        for node, up, name in (("downsample", "recon", "recon"),
                               ("quantify", "downsample", "small")):
            data = svc.queue.job(f"wf3/{node}").process_list.entries[0] \
                .params["data"]
            ds, _ = svc.result_dataset(f"wf3/{up}", name)
            assert isinstance(data, torch.Tensor) and data is ds.backing
        got = {n: client.result(f"wf3/{n}") for n in nodes}
    want_recon = _jax_stage(_recon_spec(seed=4))
    want_small = _jax_stage(_downsample_spec("x"), want_recon)
    want_stats = _jax_stage(_quantify_spec("x"), want_small)
    np.testing.assert_allclose(got["recon"], want_recon, **TOL)
    np.testing.assert_allclose(got["downsample"], want_small, **TOL)
    np.testing.assert_allclose(got["quantify"], want_stats, **TOL)


# ============================================================ broker mode
@pytest.fixture
def slow_plugins(monkeypatch):
    """The test plugins (``torch_slow_plugins``) in a copy of the wire
    registry, restored afterwards."""
    monkeypatch.setattr(wire, "_REGISTRY", dict(wire._REGISTRY))
    for cls in importlib.import_module("torch_slow_plugins").PLUGINS:
        wire.register_plugin(cls)


def _reap(workers):
    for p in workers:
        if p.poll() is None:
            p.kill()
    for p in workers:
        p.wait(timeout=10)


def test_sigkill_mid_downstream_does_not_rerun_upstream(tmp_path,
                                                        slow_plugins):
    """SIGKILL the worker running a DOWNSTREAM node: the lease expires,
    the node requeues, and the resumed attempt consumes the upstream
    output already materialised in the result store — the upstream is
    NOT re-executed (one ``attempt`` span on it, its ``attempt`` counter
    stays 1) and the final volume is bit-identical to the same stages
    submitted sequentially by hand."""
    with _service(workers_remote=True, lease_ttl=1.5,
                  sweep_interval=0.1) as svc:
        host, port = svc.serve(port=0)
        url = f"http://{host}:{port}"
        client = PipelineClient(url, timeout=60.0)
        workers = spawn_local_workers(
            url, 2, transport="cuda", device="cpu",
            checkpoint_dir=str(tmp_path / "ckpts"), poll=0.05,
            heartbeat=0.3, imports=("torch_slow_plugins",),
            worker_ids=["w0", "w1"], pythonpath_extra=(TESTS_DIR,))
        by_id = dict(zip(["w0", "w1"], workers))
        try:
            reply = client.workflow({
                "up": {"process_list": _recon_spec(seed=11, n_rows=4)},
                "down": {"process_list":
                         _passthrough_spec("up", "recon", delay=2.0)},
            }, workflow_id="wf-kill")
            assert reply["nodes"] == ["up", "down"]
            deadline = time.time() + WAIT_S
            while True:
                snap = client.workflow_status("wf-kill")
                down = snap["node_jobs"]["down"]
                if down["state"] == "running" and down["worker_id"]:
                    break
                assert down["state"] not in ("done", "failed"), snap
                assert time.time() < deadline, snap
                time.sleep(0.05)
            assert snap["node_jobs"]["up"]["state"] == "done"
            victim = down["worker_id"]
            time.sleep(0.5)                      # into the slow step
            os.kill(by_id[victim].pid, signal.SIGKILL)

            snap = client.wait_workflow("wf-kill", timeout=WAIT_S)
            assert snap["state"] == "done", snap
            up, down = snap["node_jobs"]["up"], snap["node_jobs"]["down"]
            assert down["attempt"] >= 2, down    # requeued after expiry
            assert down["worker_id"] != victim, down
            assert up["attempt"] == 1, up        # upstream NOT re-run
            tr = client.workflow_trace("wf-kill")
            names_up = [s["name"] for s in tr["nodes"]["up"]["spans"]]
            names_down = [s["name"] for s in tr["nodes"]["down"]["spans"]]
            assert names_up.count("attempt") == 1
            assert names_down.count("attempt") >= 1
            assert "checkpoint.restore" in names_down
            assert "upstream.fetch" in names_down
            wf_vol = client.result("wf-kill/down", "vol")
            jid = client.submit(_recon_spec(seed=11, n_rows=4),
                                job_id="seq-up")
            assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
            jid2 = client.submit(_passthrough_spec("seq-up", "recon"),
                                 job_id="seq-down")
            assert client.wait(jid2, timeout=WAIT_S)["state"] == "done"
            np.testing.assert_array_equal(wf_vol,
                                          client.result("seq-down", "vol"))
            assert client.stats()["leases_expired"] >= 1
        finally:
            _reap(workers)


def test_three_stage_workflow_broker_acceptance():
    """recon -> downsample -> quantify as ONE ``POST /workflows`` in
    broker mode with two worker processes: downstream inputs resolve
    from upstream outputs over the wire, the final stats are
    bit-identical to the same stages submitted sequentially by hand, the
    recon within the chain's bound of the JAX package's, and
    ``GET /workflows/{id}`` + ``/trace`` report per-node status on one
    linked timeline."""
    with _service(workers_remote=True, lease_ttl=10.0,
                  sweep_interval=0.2) as svc:
        host, port = svc.serve(port=0)
        url = f"http://{host}:{port}"
        client = PipelineClient(url, timeout=60.0)
        workers = spawn_local_workers(url, 2, transport="cuda",
                                      device="cpu", poll=0.05,
                                      worker_ids=["w0", "w1"])
        try:
            reply = client.workflow({
                "recon": {"process_list": _recon_spec(seed=3)},
                "downsample": {"process_list": _downsample_spec("recon")},
                "quantify": {"process_list": _quantify_spec("downsample"),
                             "after": ["downsample"]},
            }, workflow_id="wf-accept")
            assert reply["n_nodes"] == 3
            snap = client.wait_workflow("wf-accept", timeout=WAIT_S)
            assert snap["state"] == "done", snap
            assert snap["counts"] == {"done": 3}
            assert snap["edges"]["downsample"] == ["recon"]
            assert snap["edges"]["quantify"] == ["downsample"]
            j1 = client.submit(_recon_spec(seed=3), job_id="s-recon")
            assert client.wait(j1, timeout=WAIT_S)["state"] == "done"
            j2 = client.submit(_downsample_spec("s-recon"), job_id="s-down")
            assert client.wait(j2, timeout=WAIT_S)["state"] == "done"
            j3 = client.submit(_quantify_spec("s-down"), job_id="s-quant")
            assert client.wait(j3, timeout=WAIT_S)["state"] == "done"
            stats = client.result("wf-accept/quantify", "stats")
            np.testing.assert_array_equal(
                stats, client.result("s-quant", "stats"))
            np.testing.assert_array_equal(
                client.result("wf-accept/downsample", "small"),
                client.result("s-down", "small"))
            # the first stage against the JAX package's on the same spec
            jr = R.PluginRunner(JS.from_spec(_recon_spec(seed=3)),
                                R.InMemoryTransport())
            np.testing.assert_allclose(
                client.result("wf-accept/recon", "recon"),
                np.asarray(jr.transport.read(jr.run()["recon"])), **TOL)
            tr = client.workflow_trace("wf-accept")
            assert sorted(tr["nodes"]) == ["downsample", "quantify",
                                           "recon"]
            for node in ("downsample", "quantify"):
                names = [s["name"] for s in tr["nodes"][node]["spans"]]
                assert "upstream.fetch" in names, (node, names)
            assert all(snap["node_jobs"][n]["worker_id"] in ("w0", "w1")
                       for n in snap["node_jobs"])
            out = client.cancel_workflow("wf-accept")
            assert out["cancelled"] == []
        finally:
            _reap(workers)
