"""The port's checkpoint store against tests/test_checkpoint.py:
liveness, kill/resume bit-identical on each transport, incremental and
hard-linked checkpoints, v1 ``.npy`` checkpoints, chunk-file IO, and the
loud failures — in its port form where the port differs (a dropped
backing instead of a donated buffer).  Plus checkpoints written by the
JAX package loading in the port."""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as R
import repro.service as JS

from repro_torch.core import (BaseFilter, BaseLoader, BasePlugin, BaseSaver,
                              ChunkedFile, ChunkedFileTransport,
                              CudaTransport, DataSet, InMemoryTransport,
                              PluginRunner, ProcessList)
from repro_torch.service import CheckpointError, CheckpointStore


# ---------------------------------------------------------------- helpers
class VolLoader(BaseLoader):
    name = "vol_loader"
    parameters = {"array": None}
    data_params = ("array",)

    def load(self):
        a = self.params["array"]
        d = DataSet(self.out_dataset_names[0], a.shape, a.dtype,
                    ("theta", "y", "x"), backing=a)
        d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
        return [d]


class AddF(BaseFilter):
    name = "add_f"
    parameters = {"add": 0.0}

    def process_frames(self, frames):
        return frames[0] + self.params["add"]


class Combine(BasePlugin):
    """2-in quality check: the late consumer that keeps its inputs live."""
    name = "combine"
    n_in_datasets = 2

    def setup(self, in_datasets):
        dout = in_datasets[0].like(self.out_dataset_names[0])
        self.chunk_frames(self.default_pattern(in_datasets[0]))
        return [dout]

    def process_frames(self, frames):
        return frames[0] - 0.5 * frames[1]


class NullSaver(BaseSaver):
    name = "null_saver"

    def save(self, ds):
        ds.metadata["saved"] = True


def branching_chain(a) -> ProcessList:
    """raw -> a -> b, then combine(b, a): 'a' is read again AFTER its
    replacement-chain successor was produced."""
    pl = ProcessList()
    pl.add(VolLoader, params={"array": a}, out_datasets=("raw",))
    pl.add(AddF, params={"add": 1.0},
           in_datasets=("raw",), out_datasets=("a",))
    pl.add(AddF, params={"add": 2.0},
           in_datasets=("a",), out_datasets=("b",))
    pl.add(Combine, in_datasets=("b", "a"), out_datasets=("out",))
    pl.add(NullSaver, in_datasets=("out",))
    return pl


def _cpu():
    return InMemoryTransport(device="cpu")


@pytest.fixture
def data(rng):
    return rng.normal(size=(4, 6, 5)).astype(np.float32)


def _want(a):
    return (a + 3.0) - 0.5 * (a + 1.0)


# ---------------------------------------------------------------- liveness
def test_required_live_names(data):
    r = PluginRunner(branching_chain(data), _cpu())
    r.prepare()
    assert r.n_steps == 3
    assert r.required_live_names(1) == {"a"}
    assert r.required_live_names(2) == {"a", "b"}
    assert r.required_live_names(3) == {"out"}


def test_last_use_flags_set_per_step(data):
    seen = {}

    class SpyCombine(Combine):
        def pre_process(self):
            seen[self.name] = [pd.last_use for pd in self.in_data]

    class SpyAdd(AddF):
        def pre_process(self):
            seen[self.params["add"]] = [pd.last_use
                                        for pd in self.in_data]

    pl = ProcessList()
    pl.add(VolLoader, params={"array": data}, out_datasets=("raw",))
    pl.add(SpyAdd, params={"add": 1.0},
           in_datasets=("raw",), out_datasets=("a",))
    pl.add(SpyAdd, params={"add": 2.0},
           in_datasets=("a",), out_datasets=("b",))
    pl.add(SpyCombine, in_datasets=("b", "a"), out_datasets=("out",))
    pl.add(NullSaver, in_datasets=("out",))
    PluginRunner(pl, _cpu()).run()
    assert seen[1.0] == [True]
    assert seen[2.0] == [False]
    assert seen["combine"] == [True, True]


def test_cuda_transport_branching_chain_survives_release(data):
    """The port's form of the donation regression: CudaTransport drops
    an input only at its final use, so the combiner still reads 'a'."""
    tr = CudaTransport("cpu")
    r = PluginRunner(branching_chain(data), tr)
    r.run()
    np.testing.assert_allclose(tr.read(r.datasets["out"]), _want(data),
                               rtol=1e-6)


# ------------------------------------------------------- kill/resume
def _interrupted_run(chain_fn, a, transport_factory, store, job_id,
                     kill_after=2):
    ref = PluginRunner(chain_fn(a), transport_factory())
    ref.run()
    want = np.asarray(ref.transport.read(ref.datasets["out"]))

    r1 = PluginRunner(chain_fn(a), transport_factory())
    r1.prepare()
    for _ in range(kill_after):
        r1.step()
        store.save(job_id, r1)
    r2 = PluginRunner(chain_fn(a), transport_factory())
    assert store.restore(job_id, r2) == kill_after
    while r2.step():
        pass
    r2.finalise()
    got = np.asarray(r2.transport.read(r2.datasets["out"]))
    return got, want, r2


def test_kill_resume_bit_identical_cuda_transport(tmp_path, data):
    """With inputs dropped at their final use, the interrupted-then-
    resumed run still sees every dataset a later plugin needs, and the
    restored datasets land on the runner transport's device."""
    store = CheckpointStore(str(tmp_path))
    got, want, r2 = _interrupted_run(
        branching_chain, data, lambda: CudaTransport("cpu"), store, "jS")
    np.testing.assert_array_equal(got, want)


def test_kill_resume_bit_identical_chunked(tmp_path, data):
    store = CheckpointStore(str(tmp_path / "store"))
    dirs = iter(range(100))

    def factory():
        return ChunkedFileTransport(
            directory=str(tmp_path / f"tr{next(dirs)}"), device="cpu")

    got, want, _ = _interrupted_run(branching_chain, data, factory,
                                    store, "jC")
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- incremental behaviour
def test_incremental_checkpoint_skips_unchanged_dense_datasets(
        tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(branching_chain(data), _cpu())
    r.prepare()
    r.step()
    s1 = store.save("j1", r)
    r.step()
    s2 = store.save("j1", r)
    assert s1["files_written"] == 2 and s1["files_reused"] == 0
    assert s2["files_written"] == 1 and s2["files_reused"] == 2
    assert s2["bytes_written"] < s1["bytes_written"]
    man = store.load("j1")
    assert man["version"] == 2
    by_name = {e["name"]: e for e in man["datasets"]}
    assert by_name["raw"]["chunks_written"] == []
    assert by_name["b"]["chunks_written"] == "all"
    assert set(man["required"]) == {"a", "b"}


def test_chunked_backing_is_linked_not_copied(tmp_path, data):
    store = CheckpointStore(str(tmp_path / "store"))
    tr = ChunkedFileTransport(directory=str(tmp_path / "tr"), device="cpu")
    r = PluginRunner(branching_chain(data), tr)
    r.prepare()
    r.step()
    s1 = store.save("j1", r)
    assert s1["files_linked"] >= 1
    cf = r.datasets["a"].backing
    assert isinstance(cf, ChunkedFile)
    ckpt = os.path.join(str(tmp_path / "store"), "j1", "a.ckpt")
    assert os.path.samefile(cf.path, ckpt)
    assert cf.dirty == set()
    r.step()
    s2 = store.save("j1", r)
    man = store.load("j1")
    by_name = {e["name"]: e for e in man["datasets"]}
    assert by_name["a"]["chunks_written"] == []
    assert s2["files_reused"] >= 1


def test_v1_npy_checkpoints_remain_restorable(tmp_path, data):
    v1 = CheckpointStore(str(tmp_path), format="npy")
    r = PluginRunner(branching_chain(data), _cpu())
    r.prepare()
    r.step()
    r.step()
    st = v1.save("j1", r)
    assert st["files_written"] == 3
    man = v1.load("j1")
    assert all(e["format"] == "npy" for e in man["datasets"])
    r2 = PluginRunner(branching_chain(data), _cpu())
    assert CheckpointStore(str(tmp_path)).restore("j1", r2) == 2
    while r2.step():
        pass
    r2.finalise()
    got = np.asarray(r2.transport.read(r2.datasets["out"]))
    ref = PluginRunner(branching_chain(data), _cpu())
    np.testing.assert_array_equal(got, ref.transport.read(ref.run()["out"]))


def test_checkpoint_written_by_jax_package_loads_in_port(tmp_path, data):
    """Same manifest, same files: every dataset of a checkpoint the JAX
    package wrote loads in the port's store, onto the port's device."""
    class JVol(R.BaseLoader):
        name = "vol_loader"
        parameters = {"array": None}
        data_params = ("array",)

        def load(self):
            a = self.params["array"]
            d = R.DataSet(self.out_dataset_names[0], a.shape, a.dtype,
                          ("theta", "y", "x"), backing=a)
            d.add_pattern("PROJECTION", core=("y", "x"), slice_=("theta",))
            return [d]

    class JAdd(R.BaseFilter):
        name = "add_f"
        parameters = {"add": 0.0}

        def process_frames(self, frames):
            return frames[0] + self.params["add"]

    class JSaver(R.BaseSaver):
        name = "null_saver"

        def save(self, ds):
            pass

    pl = R.ProcessList()
    pl.add(JVol, params={"array": data}, out_datasets=("raw",))
    pl.add(JAdd, params={"add": 1.0}, in_datasets=("raw",),
           out_datasets=("a",))
    pl.add(JAdd, params={"add": 2.0}, in_datasets=("a",),
           out_datasets=("b",))
    pl.add(JSaver, in_datasets=("a", "b"))
    jr = R.PluginRunner(pl, R.InMemoryTransport())
    jr.prepare()
    jr.step()
    jr.step()
    JS.CheckpointStore(str(tmp_path)).save("j1", jr)
    man = json.load(open(tmp_path / "j1" / "checkpoint.nxs.json"))
    store = CheckpointStore(str(tmp_path))
    for ent in man["datasets"]:
        ds = DataSet(ent["name"], ent["shape"], ent["dtype"],
                     ent["axis_labels"])
        store._load_entry(str(tmp_path / "j1"), ent, ds,
                          torch.device("cpu"))
        want = {"raw": data, "a": data + 1,
                "b": (data + 1) + 2}[ent["name"]]
        np.testing.assert_array_equal(ds.backing.numpy(), want)


# ----------------------------------------------- ChunkedFile IO paths
def test_chunked_file_full_chunk_write_skips_read(tmp_path):
    cf = ChunkedFile(str(tmp_path / "t.dat"), (6, 6), np.float32, (4, 4),
                     cache_bytes=64)
    cf.write_all(np.ones((6, 6), np.float32))
    assert cf.stats.chunk_reads == 0 and cf.stats.bytes_read == 0
    cf.write((slice(1, 3), slice(0, 6)), np.zeros((2, 6), np.float32))
    assert cf.stats.chunk_reads > 0


def test_chunked_file_dirty_tracking(tmp_path):
    cf = ChunkedFile(str(tmp_path / "t.dat"), (8, 8), np.float32, (4, 4))
    cf.write_all(np.ones((8, 8), np.float32))
    assert cf.dirty == {0, 1, 2, 3}
    cf.mark_clean()
    assert cf.dirty == set()
    cf.write((slice(0, 2), slice(0, 2)), np.zeros((2, 2), np.float32))
    assert cf.dirty == {0}
    cf.flush()
    assert cf.dirty == {0}


def test_chunked_file_readonly_mode(tmp_path):
    path = str(tmp_path / "t.dat")
    cf = ChunkedFile(path, (4, 4), np.float32, (2, 2))
    ref = np.arange(16, dtype=np.float32).reshape(4, 4)
    cf.write_all(ref)
    ro = ChunkedFile(path, (4, 4), np.float32, (2, 2), mode="r")
    np.testing.assert_array_equal(ro.read_all(), ref)
    with pytest.raises(OSError):
        ro.write((slice(0, 2), slice(0, 2)), np.zeros((2, 2)))


def test_chunked_file_load_from(tmp_path):
    ref = np.arange(64, dtype=np.float32).reshape(8, 8)
    src = ChunkedFile(str(tmp_path / "src.dat"), (8, 8), np.float32,
                      (4, 4))
    src.write_all(ref)
    dst = ChunkedFile(str(tmp_path / "dst.dat"), (8, 8), np.float32,
                      (4, 4))
    dst.load_from(src.path)
    np.testing.assert_array_equal(dst.read_all(), ref)


# ------------------------------------------------------- loud failures
def test_restore_raises_when_required_dataset_missing(tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(branching_chain(data), _cpu())
    r.prepare()
    r.step()
    r.step()
    store.save("j1", r)
    mpath = os.path.join(str(tmp_path), "j1", "checkpoint.nxs.json")
    man = json.load(open(mpath))
    man["datasets"] = [e for e in man["datasets"] if e["name"] != "a"]
    json.dump(man, open(mpath, "w"))
    r2 = PluginRunner(branching_chain(data), _cpu())
    with pytest.raises(CheckpointError, match="required dataset"):
        store.restore("j1", r2)


def test_restore_raises_when_required_file_unreadable(tmp_path, data):
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(branching_chain(data), _cpu())
    r.prepare()
    r.step()
    r.step()
    store.save("j1", r)
    os.remove(os.path.join(str(tmp_path), "j1", "a.ckpt"))
    r2 = PluginRunner(branching_chain(data), _cpu())
    with pytest.raises(CheckpointError, match="unreadable"):
        store.restore("j1", r2)


def test_save_refuses_dead_required_dataset(tmp_path, data):
    """If the transport dropped a backing the resume still needs, the
    checkpoint must refuse — an unresumable checkpoint is worse than
    none.  (The port drops an input by setting its backing to None.)"""
    store = CheckpointStore(str(tmp_path))
    r = PluginRunner(branching_chain(data), CudaTransport("cpu"))
    r.prepare()
    r.step()
    r.datasets["a"].backing = None
    with pytest.raises(CheckpointError, match="dropped"):
        store.save("j1", r)
    assert store.load("j1") is None          # nothing half-written
