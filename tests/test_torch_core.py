"""The port's framework core against the JAX package's: patterns on
tensors, the chunking optimiser, the plugin-list check, process lists
saved by ``repro``, transports, liveness and the runner.  All on the CPU
(``device="cpu"``)."""
import json

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.chunking import optimise_chunks as jax_optimise_chunks
from repro.core.patterns import Pattern as JaxPattern
from repro.tomo import standard_chain as jax_standard_chain

from repro_torch.core import (BaseLoader, BasePlugin, BaseSaver, ChunkedFile,
                              ChunkedFileTransport, CudaTransport, DataSet,
                              GangSignatureMismatch, GPU_DRIVER,
                              InMemoryTransport, LambdaFilter,
                              LocalCompileCache, Pattern, PluginRunner,
                              ProcessList, ProcessListError, Profiler,
                              ShardedTransport, chunks_touched, naive_chunks,
                              optimise_chunks, run_process_list)
from repro_torch.core.framework import step_together
from repro_torch.obs import Trace, use_trace


# ------------------------------------------------------------- patterns
@pytest.mark.parametrize("shape,core,slice_", [
    ((3, 4, 5), (1, 2), (0,)), ((3, 4, 5), (0, 2), (1,)),
    ((3, 4, 5), (0, 1), (2,)), ((2, 3, 4, 5), (2, 3), (1, 0)),
    ((2, 3, 4, 5), (0,), (3, 1, 2)), ((2, 3, 4, 5), (1, 3), (2, 0))])
def test_to_from_frames_on_tensors_match_jax(rng, shape, core, slice_):
    a = rng.normal(size=shape).astype(np.float32)
    want = JaxPattern("P", core, slice_).to_frames(a)
    pat = Pattern("P", core, slice_)
    frames = pat.to_frames(torch.from_numpy(a))
    assert isinstance(frames, torch.Tensor)
    np.testing.assert_array_equal(frames.numpy(), want)
    np.testing.assert_array_equal(pat.to_frames(a), want)   # numpy too
    back = pat.from_frames(frames, shape)
    np.testing.assert_array_equal(back.numpy(), a)


def test_pattern_validation_and_dim_types():
    with pytest.raises(ValueError, match="overlap"):
        Pattern("bad", (0, 1), (1,))
    with pytest.raises(ValueError, match="cover"):
        Pattern("bad", (0,), (2,))
    p = Pattern("P", (2,), (0, 1))
    j = JaxPattern("P", (2,), (0, 1))
    assert [p.dim_type(d) for d in range(3)] == \
        [j.dim_type(d) for d in range(3)]
    assert list(p.frame_slices((4, 3, 2), m=3)) == \
        list(j.frame_slices((4, 3, 2), m=3))


# ------------------------------------------------------------- chunking
_CHUNK_CASES = [
    ((1801, 16, 2560), (1, 2), (0,), (0, 2), (1,), 2, 8),
    ((64, 8, 64), (1, 2), (0,), (0, 2), (1,), 4, 1),
    ((91, 7, 100), (0, 2), (1,), (1, 2), (0,), 4, 16),
    ((10, 10, 10, 10), (2, 3), (0, 1), (0, 3), (1, 2), 1, 3),
    ((200, 300), (1,), (0,), None, None, 4, 8),
]


@pytest.mark.parametrize("shape,nc,ns,xc,xs,itemsize,frames", _CHUNK_CASES)
def test_optimise_chunks_matches_jax(shape, nc, ns, xc, xs, itemsize,
                                     frames):
    now = Pattern("NOW", nc, ns)
    nxt = Pattern("NEXT", xc, xs) if xc is not None else None
    jnow = JaxPattern("NOW", nc, ns)
    jnxt = JaxPattern("NEXT", xc, xs) if xc is not None else None
    for cache in (1_000_000, 64_000):
        got = optimise_chunks(shape, now, nxt, itemsize=itemsize,
                              frames=frames, cache_bytes=cache)
        assert got == jax_optimise_chunks(shape, jnow, jnxt,
                                          itemsize=itemsize, frames=frames,
                                          cache_bytes=cache)
        assert int(np.prod(got)) * itemsize <= cache
    assert naive_chunks(shape, itemsize) == R.naive_chunks(shape, itemsize)
    idx = tuple(slice(0, min(3, s)) for s in shape)
    assert chunks_touched(shape, got, idx) == R.chunks_touched(shape, got,
                                                               idx)


# ------------------------------------------------------------ test chain
class ArrayLoader(BaseLoader):
    name = "array_loader"

    def __init__(self, array=None, labels=("theta", "y", "x"), **kw):
        super().__init__(**kw)
        self.array = array
        self.labels = labels

    def load(self):
        d = DataSet(self.out_dataset_names[0], self.array.shape,
                    self.array.dtype, self.labels, backing=self.array)
        d.add_pattern("PROJECTION", core=self.labels[1:],
                      slice_=self.labels[:1])
        d.add_pattern("SINOGRAM", core=(self.labels[0], self.labels[2]),
                      slice_=(self.labels[1],))
        return [d]


class CaptureSaver(BaseSaver):
    name = "capture_saver"
    captured = {}

    def save(self, ds):
        b = ds.backing
        CaptureSaver.captured[ds.name] = (
            b.read_all() if isinstance(b, ChunkedFile)
            else (b.cpu().numpy() if isinstance(b, torch.Tensor)
                  else np.asarray(b)))


def _double(b):
    return b * 2.0


def _plus_one(b):
    return b + 1.0


def _chain(a, frames=1):
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": a}, out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _double, "pattern": "PROJECTION",
                                 "frames": frames},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _plus_one, "pattern": "SINOGRAM",
                                 "frames": frames},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(CaptureSaver, in_datasets=("tomo",))
    return pl


@pytest.fixture
def data(rng):
    return rng.normal(size=(8, 6, 4)).astype(np.float32)


_TRANSPORTS = {
    "inmemory": lambda: InMemoryTransport(device="cpu"),
    "chunked": lambda: ChunkedFileTransport(device="cpu"),
    "cuda_on_cpu": lambda: CudaTransport(device="cpu"),
}


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("kind", sorted(_TRANSPORTS))
def test_transports_agree_with_jax(data, kind, frames):
    """The paper's serial-vs-cluster equivalence: every transport of the
    port gives what the JAX package's in-memory transport gives."""
    jpl = R.ProcessList()
    jpl.add(_JaxArrayLoader, params={"array": data}, out_datasets=("tomo",))
    jpl.add(R.LambdaFilter, params={"fn": _double, "pattern": "PROJECTION",
                                    "frames": frames},
            in_datasets=("tomo",), out_datasets=("tomo",))
    jpl.add(R.LambdaFilter, params={"fn": _plus_one, "pattern": "SINOGRAM",
                                    "frames": frames},
            in_datasets=("tomo",), out_datasets=("tomo",))
    jpl.add(_JaxSaver, in_datasets=("tomo",))
    _JaxSaver.captured = {}
    R.PluginRunner(jpl, R.InMemoryTransport()).run()
    CaptureSaver.captured = {}
    PluginRunner(_chain(data, frames), _TRANSPORTS[kind]()).run()
    np.testing.assert_allclose(CaptureSaver.captured["tomo"],
                               _JaxSaver.captured["tomo"], rtol=1e-6)
    np.testing.assert_allclose(CaptureSaver.captured["tomo"], data * 2 + 1,
                               rtol=1e-6)


class _JaxArrayLoader(R.BaseLoader):
    name = "array_loader"

    def __init__(self, array=None, **kw):
        super().__init__(**kw)
        self.array = array

    def load(self):
        d = R.DataSet(self.out_dataset_names[0], self.array.shape,
                      self.array.dtype, ("theta", "y", "x"),
                      backing=self.array)
        d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
        d.add_pattern("SINOGRAM", core=("theta", "x"), slice_=("y",))
        return [d]


class _JaxSaver(R.BaseSaver):
    name = "capture_saver"
    captured = {}

    def save(self, ds):
        _JaxSaver.captured[ds.name] = np.asarray(ds.backing)


def test_step_cache_builds_once_per_key(data):
    cache = LocalCompileCache()
    trace = Trace()
    with use_trace(trace):
        for _ in range(2):
            PluginRunner(_chain(data),
                         CudaTransport("cpu", compile_cache=cache)).run()
    assert cache.stats() == {"hits": 2, "misses": 2, "entries": 2}
    assert sum(s.name == "compile" for s in trace.spans()) == 2


# ------------------------------------------------------------ step_together
#: the transports that gang, with cost analysis on
_GANG_TRANSPORTS = {
    "cuda": lambda: CudaTransport("cpu", cost_analysis=True),
    "sharded": lambda: ShardedTransport(("cpu",) * 2, cost_analysis=True),
}
_COST = {"flops", "bytes", "bytes_accessed", "peak_memory"}


def _prepared(arrays, transport):
    runners = [PluginRunner(_chain(a), transport) for a in arrays]
    for r in runners:
        r.prepare()
    return runners


def _process_spans(r):
    return [s for s in r.profiler.trace.spans()
            if s.name.endswith(".process")]


def _counting(transport, method):
    """Wrap ``transport.<method>`` to record how many plugins each call
    was given."""
    calls, inner = [], getattr(transport, method)

    def counted(arg):
        calls.append(len(arg) if isinstance(arg, list) else 1)
        return inner(arg)

    setattr(transport, method, counted)
    return calls


@pytest.mark.parametrize("gang", [1, 2, 4])
@pytest.mark.parametrize("kind", sorted(_GANG_TRANSPORTS))
def test_step_together_runs_one_runner_or_a_gang(rng, kind, gang):
    """One runner steps alone through ``run_plugin``; a gang of 2 or 4
    runners on one transport steps as one ``run_plugin_batch`` call a
    step.  Each member equals its chain run alone, and each member's
    ``process`` span carries the devices, the step's cost and blocks,
    and ``gang`` only for a gang."""
    arrays = [rng.normal(size=(8, 6, 4)).astype(np.float32)
              for _ in range(gang)]
    transport = _GANG_TRANSPORTS[kind]()
    solo = _counting(transport, "run_plugin")
    batch = _counting(transport, "run_plugin_batch")
    runners = _prepared(arrays, transport)
    fell = []
    steps = 0
    while step_together(runners, lambda *a: fell.append(a)):
        steps += 1
    assert steps == 2 and fell == []
    assert (solo, batch) == (([1, 1], []) if gang == 1
                             else ([], [gang, gang]))
    devices = len(getattr(transport, "slots", [None]))
    want = {"plugin", "phase", "devices", "blocks"} | _COST
    for a, r in zip(arrays, runners):
        assert r.current_step == 2
        np.testing.assert_allclose(transport.read(r.datasets["tomo"]),
                                   a * 2 + 1, rtol=1e-6)
        spans = _process_spans(r)
        assert [s.name for s in spans] == \
            ["plugin.lambda_filter.process"] * 2
        for s in spans:
            assert set(s.attrs) == (want | {"gang"} if gang > 1 else want)
            assert s.attrs["devices"] == devices
            assert s.attrs.get("gang", 1) == gang
    assert not step_together(runners)


@pytest.mark.parametrize("kind", sorted(_GANG_TRANSPORTS))
def test_a_gang_that_shares_no_step_runs_its_members_one_by_one(rng, kind):
    """Members of different shapes share no built step: each step calls
    ``on_fallback`` once with the plugin's name and the
    :class:`GangSignatureMismatch`, then runs the members one by one;
    their spans keep ``gang`` and carry no cost."""
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((8, 6, 4), (8, 5, 4))]
    transport = _GANG_TRANSPORTS[kind]()
    solo = _counting(transport, "run_plugin")
    runners = _prepared(arrays, transport)
    fell = []
    assert step_together(runners, lambda name, err: fell.append(
        (name, type(err))))
    assert fell == [("lambda_filter", GangSignatureMismatch)]
    assert solo == [1, 1]
    while step_together(runners, lambda name, err: fell.append(
            (name, type(err)))):
        pass
    assert len(fell) == 2 and solo == [1] * 4
    for a, r in zip(arrays, runners):
        np.testing.assert_allclose(transport.read(r.datasets["tomo"]),
                                   a * 2 + 1, rtol=1e-6)
        for s in _process_spans(r):
            assert not _COST & set(s.attrs) and s.attrs["gang"] == 2


def test_a_gang_on_a_transport_without_a_gang_step(rng):
    """An ``InMemoryTransport`` has no gang step: the members run one by
    one, no fallback is reported, and their spans carry ``gang``."""
    arrays = [rng.normal(size=(8, 6, 4)).astype(np.float32)
              for _ in range(2)]
    transport = InMemoryTransport("cpu")
    solo = _counting(transport, "run_plugin")
    runners = _prepared(arrays, transport)
    fell = []
    while step_together(runners, lambda *a: fell.append(a)):
        pass
    assert fell == [] and solo == [1] * 4
    for a, r in zip(arrays, runners):
        np.testing.assert_allclose(transport.read(r.datasets["tomo"]),
                                   a * 2 + 1, rtol=1e-6)
        assert [s.attrs["gang"] for s in _process_spans(r)] == [2, 2]


def test_dataset_replacement_semantics(data):
    """An out_dataset with the same name replaces the in_dataset; a new
    name creates a parallel dataset (paper §III.B)."""
    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": data}, out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _double},
           in_datasets=("tomo",), out_datasets=("doubled",))
    pl.add(LambdaFilter, params={"fn": lambda b: b + 5.0},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(CaptureSaver, in_datasets=("doubled",))
    pl.add(CaptureSaver, in_datasets=("tomo",))
    CaptureSaver.captured = {}
    out = PluginRunner(pl, CudaTransport(device="cpu")).run()
    np.testing.assert_allclose(CaptureSaver.captured["doubled"], data * 2)
    np.testing.assert_allclose(CaptureSaver.captured["tomo"], data + 5)
    assert set(out) == {"tomo", "doubled"}


def test_liveness_matches_jax_and_drops_inputs_at_last_use(data):
    """A branching chain: the loader's 'tomo' is read by two steps.  The
    runner's liveness equals the JAX runner's, and the device transport
    keeps the dataset until its final consumer, then drops it."""
    def branch(ns):
        pl = ns.ProcessList()
        pl.add(ns.Loader, params={"array": data}, out_datasets=("tomo",))
        pl.add(ns.LambdaFilter, params={"fn": _double},
               in_datasets=("tomo",), out_datasets=("a",))
        pl.add(ns.LambdaFilter, params={"fn": _plus_one},
               in_datasets=("tomo",), out_datasets=("b",))
        pl.add(ns.LambdaFilter, params={"fn": _plus_one},
               in_datasets=("a",), out_datasets=("a",))
        pl.add(ns.Saver, in_datasets=("a",))
        pl.add(ns.Saver, in_datasets=("b",))
        return pl

    class Port:
        ProcessList, LambdaFilter = ProcessList, LambdaFilter
        Loader, Saver = ArrayLoader, CaptureSaver

    class Jax:
        ProcessList, LambdaFilter = R.ProcessList, R.LambdaFilter
        Loader, Saver = _JaxArrayLoader, _JaxSaver

    runner = PluginRunner(branch(Port), CudaTransport(device="cpu"))
    jrunner = R.PluginRunner(branch(Jax), R.InMemoryTransport())
    runner.prepare()
    jrunner.prepare()
    for step in range(runner.n_steps + 1):
        assert runner.required_live_names(step) == \
            jrunner.required_live_names(step)
    tomo = runner.datasets["tomo"]
    runner.step()                       # first reader of 'tomo'
    assert isinstance(tomo.backing, torch.Tensor)   # kept: read again
    a = runner.datasets["a"]
    runner.step()                       # last reader of 'tomo'
    assert tomo.backing is None
    runner.step()                       # last reader of the first 'a'
    assert a.backing is None
    CaptureSaver.captured = {}
    runner.finalise()
    np.testing.assert_allclose(CaptureSaver.captured["a"], data * 2 + 1)
    np.testing.assert_allclose(CaptureSaver.captured["b"], data + 1)


def test_skip_to_resumes_bit_identically(data):
    CaptureSaver.captured = {}
    full = PluginRunner(_chain(data), CudaTransport(device="cpu"))
    full.prepare()
    full.step()
    mid = full.transport.read(full.datasets["tomo"])
    while full.step():
        pass
    full.finalise()
    want = CaptureSaver.captured["tomo"]
    resumed = PluginRunner(_chain(data), CudaTransport(device="cpu"))
    resumed.skip_to(1, {"tomo": mid})
    CaptureSaver.captured = {}
    while resumed.step():
        pass
    resumed.finalise()
    np.testing.assert_array_equal(CaptureSaver.captured["tomo"], want)


def test_multi_loader_multimodal_chain(rng):
    """Fig 10: multiple loaders, a 2-in plugin combining datasets."""
    absorb = rng.normal(size=(4, 4, 4)).astype(np.float32)
    fluo = rng.normal(size=(4, 4, 4)).astype(np.float32)

    class TwoIn(BasePlugin):
        name = "combine"
        n_in_datasets = 2
        n_out_datasets = 1

        def setup(self, ins):
            dout = ins[1].like(self.out_dataset_names[0])
            self.chunk_frames(self.default_pattern(ins[0]))
            return [dout]

        def process_frames(self, frames):
            a, f = frames
            return f / (1.0 + torch.abs(a))

    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": absorb}, out_datasets=("absorb",))
    pl.add(ArrayLoader, params={"array": fluo}, out_datasets=("fluo",))
    pl.add(TwoIn, in_datasets=("absorb", "fluo"),
           out_datasets=("corrected",))
    pl.add(CaptureSaver, in_datasets=("corrected",))
    for make in _TRANSPORTS.values():
        CaptureSaver.captured = {}
        PluginRunner(pl, make()).run()
        np.testing.assert_allclose(CaptureSaver.captured["corrected"],
                                   fluo / (1 + np.abs(absorb)), rtol=1e-6)


def test_gpu_driver_plugin_refused_off_the_card(data):
    class GpuOnly(LambdaFilter):
        driver = GPU_DRIVER

    pl = ProcessList()
    pl.add(ArrayLoader, params={"array": data}, out_datasets=("tomo",))
    pl.add(GpuOnly, params={"fn": _double}, in_datasets=("tomo",),
           out_datasets=("tomo",))
    pl.add(CaptureSaver, in_datasets=("tomo",))
    with pytest.raises(RuntimeError, match="runs on"):
        PluginRunner(pl, CudaTransport(device="cpu")).run()


def test_profiler_and_manifest(tmp_path, data):
    trace = Trace()
    runner = PluginRunner(_chain(data), CudaTransport(device="cpu"),
                          profiler=Profiler(trace), output_dir=str(tmp_path))
    runner.run()
    assert "lambda_filter" in runner.profiler.totals("process")
    assert "profile" in runner.profiler.report()
    names = {s.name for s in trace.spans()}
    assert {"plugin.lambda_filter.process", "plugin.lambda_filter.pre",
            "plugin.capture_saver.io"} <= names
    man = json.load(open(tmp_path / "savu_manifest.nxs.json"))
    assert [d["name"] for d in man["datasets"]].count("tomo") >= 2
    runner.profiler.save(str(tmp_path / "events.json"))
    loaded = Profiler.load(str(tmp_path / "events.json"))
    assert loaded.totals() == pytest.approx(runner.profiler.totals())


@pytest.mark.parametrize("shape,chunks", [((5, 7, 3), (2, 3, 1)),
                                          ((9, 2, 8), (4, 1, 3)),
                                          ((2, 9, 9), (1, 4, 4))])
def test_chunked_file_region_io(tmp_path, shape, chunks):
    rng = np.random.default_rng(1)
    cf = ChunkedFile(str(tmp_path / "t.dat"), shape, np.float32, chunks,
                     cache_bytes=1024)
    ref = rng.normal(size=shape).astype(np.float32)
    cf.write_all(ref)
    np.testing.assert_array_equal(cf.read_all(), ref)
    region = tuple(slice(1, s - 1) for s in shape)
    np.testing.assert_array_equal(cf.read(region), ref[region])
    val = rng.normal(size=tuple(s - 2 for s in shape)).astype(np.float32)
    cf.write(region, val)
    cf.flush()
    ref[region] = val
    np.testing.assert_array_equal(cf.read_all(), ref)


# --------------------------------------------------------- process lists
class L(BaseLoader):
    name = "loader"

    def load(self):
        d = DataSet(self.out_dataset_names[0], (4, 4), np.float32,
                    ("a", "b"), backing=np.zeros((4, 4), np.float32))
        d.add_pattern("P", core=("b",), slice_=("a",))
        return [d]


class S(BaseSaver):
    name = "saver"

    def save(self, ds):
        pass


def _identity(b):
    return b


def _broken(kind):
    pl = ProcessList()
    if kind == "empty":
        return pl, "empty"
    if kind == "no_loader":
        pl.add(LambdaFilter, params={"fn": _identity},
               in_datasets=("x",), out_datasets=("x",))
        pl.add(S, in_datasets=("x",))
        return pl, "loader"
    pl.add(L, out_datasets=("tomo",))
    if kind == "no_saver":
        return pl, "saver"
    if kind == "unknown_input":
        pl.add(LambdaFilter, params={"fn": _identity},
               in_datasets=("nope",), out_datasets=("x",))
        pl.add(S, in_datasets=("x",))
        return pl, "nope"
    if kind == "wrong_counts":
        pl.add(LambdaFilter, params={"fn": _identity},
               in_datasets=("tomo", "tomo2"), out_datasets=("x",))
        pl.add(S, in_datasets=("x",))
        return pl, "in_datasets"
    if kind == "unknown_param":
        pl.add(LambdaFilter, params={"fn": _identity, "bogus_param": 3},
               in_datasets=("tomo",), out_datasets=("tomo",))
        pl.add(S, in_datasets=("tomo",))
        return pl, "bogus_param"
    if kind == "loader_after":
        pl.add(LambdaFilter, params={"fn": _identity},
               in_datasets=("tomo",), out_datasets=("tomo",))
        pl.add(L, out_datasets=("b",))
        pl.add(S, in_datasets=("tomo",))
        return pl, "loaders"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["empty", "no_loader", "no_saver",
                                  "unknown_input", "wrong_counts",
                                  "unknown_param", "loader_after"])
def test_process_list_check_rejects(kind):
    pl, match = _broken(kind)
    with pytest.raises(ProcessListError, match=match):
        pl.check()


def test_process_list_check_passes_and_round_trips(tmp_path):
    pl = ProcessList()
    pl.add(L, out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _identity},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(S, in_datasets=("tomo",))
    assert pl.check() == ["tomo"]
    path = str(tmp_path / "chain.json")
    pl.save(path)
    pl2 = ProcessList.load(path)
    assert [e.cls for e in pl2] == [e.cls for e in pl]
    assert pl2.entries[1].in_datasets == ("tomo",)


def test_loads_process_list_saved_by_jax_package(tmp_path):
    """State carried across: a process list the JAX package saved loads
    into the port with every plugin mapped to its counterpart."""
    import repro_torch.tomo.plugins as port_plugins
    path = str(tmp_path / "jax_chain.json")
    jax_standard_chain(n_det=32, n_angles=16, n_rows=1, paganin=True).save(
        path)
    raw = json.load(open(path))
    assert raw[0]["plugin"].startswith("repro.tomo.plugins.")
    pl = ProcessList.load(path)
    pl.check()
    assert [e.cls.__module__ for e in pl] == ["repro_torch.tomo.plugins"] * 7
    assert pl.entries[1].cls is port_plugins.DarkFlatCorrection
    assert pl.entries[1].params == {"use_pallas": True}
    assert pl.entries[0].params["n_det"] == 32


def test_run_process_list_prepopulates_loader_datasets(rng):
    class DescribeLoader(BaseLoader):
        name = "describe_loader"
        parameters = {"shape": None}

        def load(self):
            d = DataSet(self.out_dataset_names[0], self.params["shape"],
                        np.float32, ("theta", "y", "x"))
            d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
            return [d]

    a = rng.normal(size=(3, 4, 4)).astype(np.float32)
    pl = ProcessList()
    pl.add(DescribeLoader, params={"shape": list(a.shape)},
           out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": _double, "pattern": "PROJECTION"},
           in_datasets=("tomo",), out_datasets=("filtered",))
    pl.add(S, in_datasets=("filtered",))
    out = run_process_list(pl, {"tomo": a, "filtered": np.zeros_like(a)},
                           transport=CudaTransport(device="cpu"))
    np.testing.assert_allclose(out["filtered"].backing.numpy(), a * 2.0,
                               rtol=1e-6)
