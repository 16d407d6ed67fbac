"""The port's sharded transport (Savu's MPI mode) on CPU slots, against
the JAX package's ``ShardedTransport``.

``standard_chain(n_det=64, n_angles=128, n_rows=4)`` on 1, 2 and 4 CPU
slots against the JAX transport on its tests'
one-device mesh (rtol 1e-3, atol 1e-4: the chain's bound,
``test_ref_vs_pallas_chain_agree``) and against the port's
``CudaTransport("cpu")`` bit for bit (every step is per frame, and a
slice's arithmetic does not depend on the slot that computes it).  The
split itself is held against the JAX transport over 4 host-faked
devices, run in a subprocess with ``--xla_force_host_platform_device_
count=4`` as ``benchmarks/bench_scaling.py`` does.  A split that does
not divide the reference refuses; the port deals it as Savu's MPI mode
deals frames, the first slots one entry more, and agrees with one slot
and with the reference's one-device run.  Then the port's
counterparts, on 2 slots, of the reference's tests that build a ``ShardedTransport``
(tests/test_framework.py, test_checkpoint.py, test_sweep.py,
test_service.py), and a streamed run equal to the batch run.  Last, the
gather through page-locked staging blocks (``_gather_off_cards``) on
CPU blocks with its page-locked allocations stubbed: its chunk
arithmetic, the gather bit for bit the pageable one, and the pageable
fallback (the staged path on the cards: test_torch_staged_gather.py).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

import repro.core as R
import repro.tomo as JT

from repro_torch.core import (BaseFilter, BaseLoader, BasePlugin, BaseSaver,
                              CudaTransport, DataSet, DeviceDriver,
                              LambdaFilter, PluginRunner, ProcessList,
                              ShardedTensor, ShardedTransport)
from repro_torch.kernels import tally
from repro_torch.service import (CheckpointStore, CompileCache, JobQueue,
                                 PipelineScheduler, expand_sweep,
                                 parse_sweep_block)
from repro_torch.tomo import standard_chain

TOL = dict(rtol=1e-3, atol=1e-4)
CHAIN = dict(n_det=64, n_angles=128, n_rows=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slots(n):
    return ShardedTransport(("cpu",) * n)


def _scan():
    """The JAX package's simulated scan (numpy), fed to both sides."""
    return JT.simulate_raw_scan(
        JT.phantom_stack(CHAIN["n_det"], CHAIN["n_rows"]),
        JT.ParallelGeometry(CHAIN["n_angles"], CHAIN["n_det"],
                            CHAIN["n_rows"]))


def _with_scan(pl, scan):
    pl.entries[0].params["scan"] = scan
    return pl


def _recon(transport, scan, **over):
    r = PluginRunner(_with_scan(standard_chain(**{**CHAIN, **over},
                                               device="cpu"), scan),
                     transport)
    return r.transport.read(r.run()["recon"]), r


@pytest.fixture(scope="module")
def scan():
    return _scan()


@pytest.fixture(scope="module")
def jax_one_device(scan):
    """The JAX ``ShardedTransport`` on a one-device mesh."""
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    r = R.PluginRunner(_with_scan(JT.standard_chain(**CHAIN), scan),
                       R.ShardedTransport(mesh))
    return np.asarray(r.run()["recon"].materialise())


@pytest.fixture(scope="module")
def one_card(scan):
    return _recon(CudaTransport("cpu"), scan)[0]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_chain_on_slots_matches_jax_and_one_device(scan, jax_one_device,
                                                   one_card, n):
    got, r = _recon(_slots(n), scan)
    np.testing.assert_allclose(got, jax_one_device, **TOL)
    np.testing.assert_array_equal(got, one_card)
    recon = r.datasets["recon"].backing
    assert isinstance(recon, ShardedTensor)
    assert recon.dim == 0 and len(recon.shards) == n
    assert r.n_steps == 4
    assert {e.extra.get("devices", e.devices) for e in r.profiler.events
            if e.phase == "process"} == {n}


_CHILD = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.core import PluginRunner, ShardedTransport
    from repro.tomo import (ParallelGeometry, phantom_stack,
                            simulate_raw_scan, standard_chain)

    n_det, n_angles, n_rows = %(n_det)d, %(n_angles)d, %(n_rows)d
    scan = simulate_raw_scan(phantom_stack(n_det, n_rows),
                             ParallelGeometry(n_angles, n_det, n_rows))
    mesh = jax.make_mesh((4,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    pl = standard_chain(n_det=n_det, n_angles=n_angles, n_rows=n_rows)
    pl.entries[0].params["scan"] = scan
    ds = PluginRunner(pl, ShardedTransport(mesh)).run()["recon"]
    recon = np.asarray(ds.materialise())
    spec = str(ds.backing.sharding.spec)
    # a split that does not divide: 5 angles over 2 devices
    pl = standard_chain(n_det=16, n_angles=5, n_rows=2)
    try:
        PluginRunner(pl, ShardedTransport(
            Mesh(np.asarray(jax.devices()[:2]), ("data",)))).run()
        refused = None
    except ValueError as e:
        refused = str(e)
    np.save(sys.argv[1], recon)
    print(json.dumps({"spec": spec, "refused": refused,
                      "devices": jax.device_count()}))
""")


@pytest.fixture(scope="module")
def jax_four_devices(tmp_path_factory):
    """The JAX chain over 4 host-faked devices, in a subprocess (the
    device count is fixed when jax starts)."""
    path = str(tmp_path_factory.mktemp("jax4") / "recon.npy")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run([sys.executable, "-c", _CHILD % CHAIN, path],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    return np.load(path), info


def test_four_slots_match_jax_over_four_devices(scan, jax_four_devices):
    """The one honest parity test of the split itself: the reference's
    result split as PartitionSpec('data', None, None) over 4 devices,
    the port's over 4 slots along the same dim."""
    recon, info = jax_four_devices
    assert info["devices"] == 4
    assert info["spec"] == "PartitionSpec('data', None, None)"
    got, r = _recon(_slots(4), scan)
    np.testing.assert_allclose(got, recon, **TOL)
    assert r.datasets["recon"].backing.dim == 0


def test_indivisible_split_raises_on_both_sides(jax_four_devices):
    """5 angles over 2 slots: the reference refuses the split; the port
    splits the projections 3 + 2 (a difference on purpose) and agrees
    with one slot."""
    _, info = jax_four_devices
    assert info["refused"] and "divisible by 2" in info["refused"]
    r = PluginRunner(standard_chain(16, 5, 2, device="cpu"), _slots(2))
    r.prepare()
    r.step()
    assert [tuple(t.shape) for t in r.datasets["tomo"].backing.shards] == \
        [(3, 2, 16), (2, 2, 16)]
    while r.step():
        pass
    r.finalise()
    one = PluginRunner(standard_chain(16, 5, 2, device="cpu"),
                       CudaTransport("cpu"))
    np.testing.assert_allclose(r.transport.read(r.datasets["recon"]),
                               one.transport.read(one.run()["recon"]),
                               **TOL)


UNEVEN = dict(CHAIN, n_angles=61)


@pytest.fixture(scope="module")
def uneven_scan():
    return JT.simulate_raw_scan(
        JT.phantom_stack(UNEVEN["n_det"], UNEVEN["n_rows"]),
        JT.ParallelGeometry(UNEVEN["n_angles"], UNEVEN["n_det"],
                            UNEVEN["n_rows"]))


def test_uneven_split_over_four_slots(uneven_scan):
    """61 angles over 4 slots: the projections split 16/15/15/15 (the
    first slot takes the one left over); the volume equals one slot's
    run and the reference's one-device run within the chain's bound."""
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ref = R.PluginRunner(_with_scan(JT.standard_chain(**UNEVEN),
                                    uneven_scan), R.ShardedTransport(mesh))
    want = np.asarray(ref.run()["recon"].materialise())
    one, _ = _recon(CudaTransport("cpu"), uneven_scan, **UNEVEN)
    tr = _slots(4)
    r = PluginRunner(_with_scan(standard_chain(**UNEVEN, device="cpu"),
                                uneven_scan), tr)
    raw = tr.device_put(r.prepare().datasets["tomo"])
    assert [t.shape[0] for t in raw.shards] == [16, 15, 15, 15]
    got = tr.read(r.run()["recon"])
    np.testing.assert_allclose(got, one, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    assert tr.stats()["alltoalls"] == 1


@pytest.mark.parametrize("n", [2, 4])
def test_stats_count_the_all_to_all(scan, n):
    """One transition (PROJECTION -> SINOGRAM after the correction):
    (n - 1) / n of the fp32 corrected stack crosses between slots."""
    _, r = _recon(_slots(n), scan)
    st = r.transport.stats()
    stack = CHAIN["n_det"] * CHAIN["n_angles"] * CHAIN["n_rows"] * 4
    assert st["alltoalls"] == 1
    assert st["alltoall_bytes"] == stack * (n - 1) // n
    assert st["slots"] == ["cpu"] * n


@pytest.mark.parametrize("core,slice_,shard_axes,data_axis", [
    ((1, 2), (0,), {}, "data"),
    ((0, 2), (1,), {}, "data"),
    ((1, 2), (0,), {}, None),
    ((2,), (1, 0), {0: "model"}, "data"),
    ((0, 1, 2), (), {}, "data"),
])
def test_to_spec_is_the_references_to_pspec(core, slice_, shard_axes,
                                            data_axis):
    from repro_torch.core import Pattern
    jp = R.Pattern("P", core, slice_).with_shard_axes(shard_axes)
    tp = Pattern("P", core, slice_).with_shard_axes(shard_axes)
    assert tp.shard_axes == jp.shard_axes
    assert tp.to_spec(data_axis) == tuple(jp.to_pspec(data_axis))


# ------------------------------------------------------ small chains
class ArrayLoader(BaseLoader):
    name = "array_loader"
    parameters = {"array": None}
    data_params = ("array",)

    def load(self):
        a = self.params["array"]
        d = DataSet(self.out_dataset_names[0], a.shape, a.dtype,
                    ("theta", "y", "x"), backing=a)
        d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
        d.add_pattern("SINOGRAM", core=("theta", "x"), slice_=("y",))
        return [d]


class Saver(BaseSaver):
    name = "null_saver"

    def save(self, ds):
        ds.metadata["saved"] = True


class AddF(BaseFilter):
    name = "add_f"
    parameters = {"add": 0.0}

    def process_frames(self, frames):
        return frames[0] + self.params["add"]


class Combine(BasePlugin):
    """2-in: the late consumer that keeps its second input live."""
    name = "combine"
    n_in_datasets = 2

    def setup(self, in_datasets):
        dout = in_datasets[0].like(self.out_dataset_names[0])
        self.chunk_frames(self.default_pattern(in_datasets[0]))
        return [dout]

    def process_frames(self, frames):
        return frames[0] - 0.5 * frames[1]


class Doubled(BaseFilter):
    """No data axis: runs once, on the whole dataset, replicated."""
    name = "doubled_replicated"
    driver = DeviceDriver(axes=())
    seen: list = []

    def process_frames(self, frames):
        Doubled.seen.append(tuple(frames[0].shape))
        return frames[0] * 2.0


def _double(b):
    return b * 2.0


def _plus_one(b):
    return b + 1.0


def _lambda_chain(a):
    """x * 2 by projections, then + 1 by sinograms (one transition)."""
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _double, "pattern": "PROJECTION"},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _plus_one, "pattern": "SINOGRAM"},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(Saver, in_datasets=("tomo",))
    return pl


def _branching_chain(a):
    """raw -> a -> b, then combine(b, a): 'a' is read again after its
    successor was produced."""
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("raw",))
    pl.add(AddF, params={"add": 1.0}, in_datasets=("raw",),
           out_datasets=("a",))
    pl.add(AddF, params={"add": 2.0}, in_datasets=("a",),
           out_datasets=("b",))
    pl.add(Combine, in_datasets=("b", "a"), out_datasets=("out",))
    pl.add(Saver, in_datasets=("out",))
    return pl


@pytest.fixture
def data(rng):
    return rng.normal(size=(8, 6, 4)).astype(np.float32)


def test_replicated_plugin_equals_its_one_device_run(data):
    """A plugin with no data axis gets every entry ``None`` (the
    reference's spec): it runs once on the whole dataset, and what it
    gives is placed on every slot; the next plugin cuts its share from
    its own replica, moving nothing."""
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": data}, out_datasets=("tomo",))
    pl.add(Doubled, in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(AddF, params={"add": 1.0}, in_datasets=("tomo",),
           out_datasets=("tomo",))
    pl.add(Saver, in_datasets=("tomo",))
    Doubled.seen = []
    one = PluginRunner(pl, CudaTransport("cpu"))
    want = one.transport.read(one.run()["tomo"])
    Doubled.seen = []
    tr = _slots(2)
    r = PluginRunner(pl, tr)
    r.prepare()
    r.step()
    mid = r.datasets["tomo"].backing
    assert Doubled.seen == [data.shape]
    assert mid.dim is None and len(mid.shards) == 2
    while r.step():
        pass
    np.testing.assert_array_equal(tr.read(r.datasets["tomo"]), want)
    np.testing.assert_array_equal(want, data * 2 + 1)
    assert tr.stats()["alltoall_bytes"] == 0


def test_transports_agree(data):
    """tests/test_framework.py:78 on 2 slots."""
    r = PluginRunner(_lambda_chain(data), _slots(2))
    got = r.transport.read(r.run()["tomo"])
    np.testing.assert_allclose(got, data * 2 + 1, rtol=1e-6)
    assert r.n_steps == 2
    assert r.transport.stats()["alltoalls"] == 1


def test_branching_chain_survives_the_final_use_drop(data):
    """tests/test_checkpoint.py:139 on 2 slots: every slot's share of
    'a' lives until the combiner, its final use, and all go then."""
    tr = _slots(2)
    r = PluginRunner(_branching_chain(data), tr)
    a_after = []
    r.prepare()
    while r.step():
        a_after.append(r.datasets["a"].backing)
    r.finalise()
    np.testing.assert_allclose(tr.read(r.datasets["out"]),
                               (data + 3.0) - 0.5 * (data + 1.0), rtol=1e-6)
    assert [type(b).__name__ for b in a_after] == [
        "ShardedTensor", "ShardedTensor", "NoneType"]
    assert len(a_after[1].shards) == 2


def test_kill_resume_on_slots_bit_for_bit(tmp_path, data):
    """tests/test_checkpoint.py:176 on 2 slots: interrupted after two
    steps and resumed from the checkpoint, whose datasets come back
    split over the slots, equal to the uninterrupted run bit for bit."""
    store = CheckpointStore(str(tmp_path))
    ref = PluginRunner(_branching_chain(data), _slots(2))
    want = ref.transport.read(ref.run()["out"])
    r1 = PluginRunner(_branching_chain(data), _slots(2))
    r1.prepare()
    for _ in range(2):
        r1.step()
        store.save("jS", r1)
    r2 = PluginRunner(_branching_chain(data), _slots(2))
    assert store.restore("jS", r2) == 2
    for name in ("a", "b"):
        b = r2.datasets[name].backing
        assert isinstance(b, ShardedTensor) and len(b.shards) == 2
    while r2.step():
        pass
    r2.finalise()
    np.testing.assert_array_equal(r2.transport.read(r2.datasets["out"]),
                                  want)


SWEEP_CHAIN = dict(n_det=20, n_angles=20, n_rows=2)


def test_sweep_gang_on_slots_one_call_per_kernel_per_slot(monkeypatch):
    """tests/test_sweep.py:51,108 on 2 slots: three cutoffs gang as one
    call per step on each slot (each kernel's function called once per
    slot per step: its plain version here), one build per plugin step,
    and every variant equal to its solo run on the slots bit for bit,
    and to its solo run on one device within the chain's bound: at this
    20 x 20 x 2 geometry the ring removal's ``torch.mean`` over 20
    angles rounds differently on the CPU for one frame a call than for
    two (by 1.5e-8; at 64 x 128 x 4 every step is bit for bit)."""
    chain = standard_chain(**SWEEP_CHAIN, seed=3, device="cpu")
    axis = {"plugin": "sinogram_filter", "param": "cutoff",
            "values": [0.5, 0.75, 1.0]}
    variants = [pl for _, pl in expand_sweep(
        chain, parse_sweep_block(axis, chain))]
    calls = []
    note = tally.note
    monkeypatch.setattr(tally, "note", lambda name, cost, wrapper=None: (
        calls.append(name), note(name, cost, wrapper)))
    cache = CompileCache()
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        compile_cache=cache,
        transport_factory=lambda job: ShardedTransport(
            ("cpu",) * 2, compile_cache=cache))
    jobs = q.submit_many(variants)
    try:
        sched.start()
        assert sched.drain(timeout=120)
    finally:
        sched.shutdown()
    monkeypatch.setattr(tally, "note", note)
    assert sched.stats()["gangs_run"] == 1
    assert sched.stats()["gang_fallbacks"] == 0
    assert cache.stats()["misses"] == 4
    assert {k: calls.count(k) for k in set(calls)} == {
        "correction": 2, "spectrum_scale": 2, "backprojection": 2}
    for j, cutoff in zip(jobs, axis["values"]):
        assert j.state.value == "done", j.snapshot()
        assert {e.devices for e in j.runner.profiler.events
                if e.phase == "process"} == {2}
        got = j.runner.transport.read(j.runner.datasets["recon"])
        solo = standard_chain(**SWEEP_CHAIN, seed=3, device="cpu")
        for e in solo.entries:
            if e.cls.name == "sinogram_filter":
                e.params["cutoff"] = cutoff
        for tr in (_slots(2), CudaTransport("cpu")):
            r = PluginRunner(solo, tr)
            want = r.transport.read(r.run()["recon"])
            if isinstance(tr, ShardedTransport):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **TOL)


def test_gang_shape_mismatch_on_slots_falls_back_to_solo(rng):
    """tests/test_service.py:529 on 2 slots: one chain signature but
    different shapes cannot run as one call; the gang runs its members
    solo (counted), it does not fail."""
    arrays = [rng.normal(size=(4, 6, 6)).astype(np.float32),
              rng.normal(size=(4, 8, 8)).astype(np.float32)]
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True, batch_max=4,
        transport_factory=lambda job: _slots(2))
    jobs = [q.submit(_lambda_chain(a)) for a in arrays]
    try:
        sched.start()
        assert sched.drain(timeout=120)
    finally:
        sched.shutdown()
    assert sched.stats()["gang_fallbacks"] >= 1
    for a, j in zip(arrays, jobs):
        assert j.state.value == "done", j.snapshot()
        got = j.runner.transport.read(j.runner.datasets["tomo"])
        np.testing.assert_allclose(got, a * 2 + 1, rtol=1e-6)


def test_streamed_run_on_slots_equals_the_batch_run():
    """Streaming on 2 slots: the correction's windows run on the first
    slot as slabs land, into the growing dataset there; the barrier
    steps split it over the slots (a placement, not an all-to-all) and
    run sharded; bit for bit the batch run."""
    kw = dict(n_det=32, n_angles=40, n_rows=2)
    scan = JT.simulate_raw_scan(
        JT.phantom_stack(kw["n_det"], kw["n_rows"]),
        JT.ParallelGeometry(kw["n_angles"], kw["n_det"], kw["n_rows"]))
    batch = PluginRunner(_with_scan(standard_chain(**kw, device="cpu"),
                                    scan), _slots(2))
    want = batch.transport.read(batch.run()["recon"])
    r = PluginRunner(_with_scan(standard_chain(**kw, device="cpu"), scan),
                     _slots(2))
    r.enable_streaming()
    frames = scan["data"]
    for lo in range(0, kw["n_angles"], 7):
        assert r.feed(frames[lo:lo + 7], lo) == min(lo + 7, kw["n_angles"])
        r.pump()
    r.mark_eof()
    r.pump()
    r.finalise()
    np.testing.assert_array_equal(r.transport.read(r.datasets["recon"]),
                                  want)
    assert r.transport.stats()["alltoalls"] == 0
    assert len(r.datasets["recon"].backing.shards) == 2


def test_sharded_tensor_regions_and_placement(rng):
    """The backing's slab reads and writes (the runner's streaming hooks)
    and ``device_put`` by the dataset's pattern."""
    a = rng.normal(size=(6, 4, 3)).astype(np.float32)
    tr = _slots(2)
    ds = DataSet("v", a.shape, a.dtype, ("theta", "y", "x"), backing=a)
    ds.add_pattern("SINOGRAM", core=("theta", "x"), slice_=("y",))
    st = tr.device_put(ds)
    assert st.dim == 1 and [tuple(s.shape) for s in st.shards] == \
        [(6, 2, 3)] * 2
    np.testing.assert_array_equal(st.numpy(), a)
    for axis, lo, hi in ((1, 1, 3), (0, 2, 5), (2, 0, 2)):
        idx = tuple(slice(lo, hi) if d == axis else slice(None)
                    for d in range(3))
        np.testing.assert_array_equal(st.read_region(axis, lo, hi).numpy(),
                                      a[idx])
        st.write_region(axis, lo, hi, -a[idx])
        a[idx] = -a[idx]
        np.testing.assert_array_equal(np.asarray(st), a)
    # 4 rows over 3 slots: blocks of 2, 1 and 1, read and written across
    # their unequal bounds
    st = _slots(3).device_put(ds)
    assert [tuple(s.shape) for s in st.shards] == \
        [(6, 2, 3), (6, 1, 3), (6, 1, 3)]
    np.testing.assert_array_equal(st.numpy(), a)
    for axis, lo, hi in ((1, 1, 4), (1, 2, 3), (0, 1, 4)):
        idx = tuple(slice(lo, hi) if d == axis else slice(None)
                    for d in range(3))
        np.testing.assert_array_equal(st.read_region(axis, lo, hi).numpy(),
                                      a[idx])
        st.write_region(axis, lo, hi, a[idx] * 2)
        a[idx] = a[idx] * 2
        np.testing.assert_array_equal(np.asarray(st), a)
    with pytest.raises(ValueError, match="does not split over 5 slots"):
        _slots(5).device_put(ds)


def test_sweep_over_http_on_slots_streams_each_slot_block():
    """The HTTP service on a sharded transport factory: a sweep's stacked
    result and a variant's result stream from the slots' blocks (one
    device-to-host copy per slot block), scored where they lie, each
    equal to the variant's solo run on the slots."""
    from repro_torch.service import PipelineClient, PipelineService
    chain = standard_chain(**SWEEP_CHAIN, seed=4, device="cpu")
    cutoffs = [0.6, 1.0]
    svc = PipelineService(device="cpu", n_workers=1, batch_identical=True,
                          batch_max=4,
                          transport_factory=lambda job: _slots(2))
    host, port = svc.serve(port=0)
    try:
        client = PipelineClient(f"http://{host}:{port}", timeout=60.0)
        reply = client.sweep(chain, {"plugin": "sinogram_filter",
                                     "param": "cutoff", "values": cutoffs},
                             metric="sharpness")
        snap = client.wait_sweep(reply["sweep_id"], timeout=120)
        assert snap["state"] == "done", snap
        stacked = client.sweep_result(reply["sweep_id"])
        first = client.result(snap["variants"][0]["job_id"])
    finally:
        svc.stop()
    assert stacked.shape == (2, 2, 20, 20)
    np.testing.assert_array_equal(stacked[0], first)
    for k, cutoff in enumerate(cutoffs):
        solo = standard_chain(**SWEEP_CHAIN, seed=4, device="cpu")
        for e in solo.entries:
            if e.cls.name == "sinogram_filter":
                e.params["cutoff"] = cutoff
        r = PluginRunner(solo, _slots(2))
        np.testing.assert_array_equal(stacked[k], r.transport.read(
            r.run()["recon"]))
    assert all(np.isfinite(v["score"]) for v in snap["variants"])


def test_slot_shares_and_cache_keys(data):
    """``n_frames`` must divide each slot's frames, as in the reference;
    built steps are keyed per slot set, so one shared cache holds the
    one-device and the 2-slot steps apart."""
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": data}, out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _double, "pattern": "PROJECTION",
                                 "frames": 3},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(Saver, in_datasets=("tomo",))
    with pytest.raises(ValueError, match=r"n_frames\(3\) \| each slot's "
                                         r"frames\(4\)"):
        PluginRunner(pl, _slots(2)).run()
    cache = CompileCache()
    for tr in (CudaTransport("cpu", compile_cache=cache),
               ShardedTransport(("cpu",) * 2, compile_cache=cache),
               ShardedTransport(("cpu",) * 2, compile_cache=cache)):
        PluginRunner(_lambda_chain(data), tr).run()
    assert (cache.stats()["misses"], cache.stats()["hits"]) == (4, 2)


def test_cost_is_one_slots_step(scan):
    """``plugin_cost`` counts the first slot's share, as the reference's
    cost analysis of an SPMD program is per device: on 4 slots the
    correction's counted flops are a quarter of the one-device step's,
    and every step's work a quarter plus what each slot does whole (the
    backprojection's positions, the dark and flat it reads)."""
    costs = []
    for tr in (CudaTransport("cpu", cost_analysis=True),
               ShardedTransport(("cpu",) * 4, cost_analysis=True)):
        r = PluginRunner(_with_scan(standard_chain(**CHAIN, device="cpu"),
                                    scan), tr)
        steps = []
        while True:
            p = r.begin_step()
            if p is None:
                break
            steps.append(tr.plugin_cost(p))
            tr.run_plugin(p)
            r.complete_step()
        costs.append(steps)
    assert [c["bytes"] > 0 for c in costs[0]] == [True, False, True, True]
    assert costs[1][0]["flops"] * 4 == costs[0][0]["flops"]
    for one, slot in zip(*costs):
        for k in ("flops", "bytes"):
            assert one[k] <= slot[k] * 4 and (slot[k] < one[k] or
                                              one[k] == 0)


def test_pipeline_serve_sharded_on_the_cpu():
    """``pipeline_serve --transport sharded --slots 2`` on the CPU: a gang
    of 2 jobs on 2 slots, each verified against a serial one-device run
    (rtol 1e-3, atol 1e-4), with cost analysis on the slots."""
    from repro_torch.launch import pipeline_serve
    summary = pipeline_serve.main([
        "--device", "cpu", "--transport", "sharded", "--slots", "2",
        "--jobs", "2", "--workers", "1", "--batch", "--n-det", "16",
        "--n-angles", "12", "--n-rows", "2", "--cost-analysis"])
    assert summary["gangs_run"] == 1 and summary["gang_fallbacks"] == 0
    assert summary["max_abs_err_vs_serial"] <= 1e-4


def test_slots_are_never_remapped():
    """A slot on a device this host lacks raises (no card: the device
    rule; a card: no such index); nothing falls back to another one."""
    with pytest.raises(ValueError, match="at least one slot"):
        ShardedTransport(())
    with pytest.raises((RuntimeError, ValueError)):
        ShardedTransport(("cuda:64",) * 2)
    with pytest.raises(ValueError, match="'all' or a sequence"):
        ShardedTransport("cpu")
    assert _slots(3).stats()["slots"] == ["cpu"] * 3


# -- the gather through page-locked staging blocks (_gather_off_cards) --
MiB = 1 << 20


@pytest.mark.parametrize("shape, itemsize, rows, chunks", [
    # a 540-slice block of 2560² float32 slices: 10 slices a chunk
    ((540, 2560, 2560), 4, 10, 54),
    # 451 slices: 45 whole chunks and a last one of 1
    ((451, 2560, 2560), 4, 10, 46),
    # a block smaller than one chunk is one chunk of its own rows
    ((3, 2560, 2560), 4, 3, 1),
    # a row of exactly one staging block
    ((2, 8192, 8192), 4, 1, 2),
    ((100, 7), 2, 100, 1),
], ids=["even", "last_partial", "under_one_chunk", "row_is_a_block",
        "tiny"])
def test_stage_chunk_arithmetic(shape, itemsize, rows, chunks):
    from repro_torch.core import transport
    assert transport.STAGE_BYTES == 256 * MiB
    assert transport.stage_rows(shape, itemsize) == rows
    got = transport.stage_chunks(shape[0], rows)
    assert len(got) == chunks
    assert got[0][0] == 0 and got[-1][1] == shape[0]
    assert all(hi - lo == rows for lo, hi in got[:-1])
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert 0 < got[-1][1] - got[-1][0] <= rows
    assert rows * itemsize * int(np.prod(shape[1:])) <= transport.STAGE_BYTES


@pytest.mark.parametrize("shape, itemsize", [
    ((1, 8192, 8193), 4), ((0, 5), 4), ((5, 0), 4), ((), 4)],
    ids=["row_over_a_block", "no_rows", "empty_rows", "scalar"])
def test_blocks_that_do_not_stage(shape, itemsize):
    from repro_torch.core import transport
    assert transport.stage_rows(shape, itemsize) == 0


def _staged(monkeypatch, stage_bytes, fits=True, pin_raises=False,
            cached=False):
    """Run ``_gather_off_cards`` on CPU blocks: page-locked allocations
    are plain host tensors (recorded), the allocator's counters stubbed
    (``cached``: no allocation counts as new), ``pin_fits`` answering
    ``fits``, a ``pin_raises`` allocation raising as on a host with no
    page-locked memory left.  Returns the list of staging shapes taken."""
    from repro_torch.core import transport
    empty, taken = torch.empty, []
    count = {"n": 0}

    def pinned(*args, pin_memory=False, **kwargs):
        if pin_memory:
            if pin_raises:
                raise RuntimeError("no page-locked memory")
            taken.append(tuple(args[0]))
            count["n"] += 0 if cached else 1
        return empty(*args, **kwargs)

    monkeypatch.setattr(transport, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {
        "allocated_bytes.current": 0, "num_host_alloc": count["n"]})
    monkeypatch.setattr(transport, "pin_fits", lambda *a: fits)
    monkeypatch.setattr(torch, "empty", pinned)
    return taken


def _sharded(a, dim, k):
    """``a`` (numpy) as a ShardedTensor over ``k`` CPU slots, split along
    ``dim`` as the transport splits (None: ``k`` replicas)."""
    from repro_torch.core.transport import split_sizes
    t = torch.from_numpy(a)
    if dim is None:
        shards = [t.clone() for _ in range(k)]
    else:
        shards = [s.contiguous() for s in
                  torch.split(t, split_sizes(a.shape[dim], k), dim)]
    return ShardedTensor(shards, dim, [torch.device("cpu")] * k)


# (shape, dtype, dim, slots, stage bytes): the chunks follow each block's
# leading dim, the destination views follow ``dim``
GATHERS = {
    "even": ((8, 3, 5), np.float32, 0, 4, 64),
    "uneven_451_450_450_450": ((1801, 3, 4), np.uint16, 0, 4, 512),
    "split_dim_1": ((7, 10, 3), np.float32, 1, 4, 40),
    "split_dim_2": ((5, 2, 9), np.float64, 2, 3, 50),
    "replicated": ((6, 4, 3), np.float32, None, 4, 100),
    "one_chunk_a_slot": ((8, 3, 5), np.float32, 0, 2, 4096),
    "eight_slots_one_device": ((29, 3, 2), np.int32, 0, 8, 24),
}


@pytest.mark.parametrize("case", GATHERS)
def test_staged_gather_equals_the_pageable_gather(monkeypatch, rng, case):
    from repro_torch.core import transport
    from repro_torch.obs import Trace
    shape, dtype, dim, k, stage = GATHERS[case]
    a = (rng.normal(size=shape) * 1000).astype(dtype)
    st = _sharded(a, dim, k)
    want = st.to("cpu").numpy()
    taken = _staged(monkeypatch, stage)
    ds = DataSet("recon", shape, dtype, ("z", "y", "x"), backing=st,
                 trace=Trace())
    got = transport._gather_off_cards(ds, st)
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    assert got.tobytes() == want.tobytes() == a.tobytes()
    assert got.flags.c_contiguous and got.flags.writeable
    blocks = st.blocks()
    rows = [transport.stage_rows(b.shape, b.element_size()) for b in blocks]
    chunks = [len(transport.stage_chunks(b.shape[0], r))
              for b, r in zip(blocks, rows)]
    # one staging block for a block of one chunk, two for more, each of
    # the block's chunk rows and at most a staging block's bytes
    assert taken == [(r, *b.shape[1:]) for b, r, c in zip(blocks, rows, chunks)
                     for _ in range(min(2, c))]
    assert all(np.prod(s) * a.itemsize <= stage for s in taken)
    (span,) = ds.trace.spans()
    assert span.name == "transport.to_host"
    assert span.attrs == {"bytes": a.nbytes, "dataset": "recon",
                          "device": "cpu", "slots": k, "pinned": True,
                          "reused": False, "chunks": sum(chunks)}


def test_a_gather_whose_staging_blocks_were_cached_says_reused(monkeypatch,
                                                              rng):
    from repro_torch.core import transport
    from repro_torch.obs import Trace
    a = rng.normal(size=(9, 4, 2)).astype(np.float32)
    st = _sharded(a, 0, 3)
    _staged(monkeypatch, 32, cached=True)
    ds = DataSet("recon", a.shape, a.dtype, ("z", "y", "x"), backing=st,
                 trace=Trace())
    np.testing.assert_array_equal(transport._gather_off_cards(ds, st), a)
    (span,) = ds.trace.spans()
    assert span.attrs["pinned"] is True and span.attrs["reused"] is True
    assert span.attrs["chunks"] == 3 * 3


@pytest.mark.parametrize("fits, pin_raises, stage", [
    (False, False, 64), (True, True, 64), (True, False, 16)],
    ids=["cap_refuses", "allocation_raises", "row_over_a_block"])
def test_a_gather_that_cannot_stage_is_the_pageable_gather(
        monkeypatch, rng, fits, pin_raises, stage):
    from repro_torch.core import transport
    from repro_torch.obs import Trace
    a = rng.normal(size=(13, 2, 3)).astype(np.float32)   # a row: 24 B
    st = _sharded(a, 0, 4)
    taken = _staged(monkeypatch, stage, fits=fits, pin_raises=pin_raises)
    ds = DataSet("recon", a.shape, a.dtype, ("z", "y", "x"), backing=st,
                 trace=Trace())
    got = transport._gather_off_cards(ds, st)
    assert got.tobytes() == a.tobytes()
    assert taken == []
    (span,) = ds.trace.spans()
    assert span.attrs == {"bytes": a.nbytes, "dataset": "recon",
                          "device": "cpu", "slots": 4, "pinned": False,
                          "reused": False, "chunks": 0}
