"""The port's dry-runs (launch/dryrun.py, launch/dryrun_tomo.py) on a
fake 2 × 2 mesh at smoke sizes: the reference's record keys, the
per-device state and work, and the tomography chain's pattern
transition counted as an all-to-all."""
import contextlib

import types

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import registry
from repro_torch.launch import dryrun, perf
from repro_torch.launch.dryrun_tomo import lower_chain
from repro_torch.launch.mesh import fake_process_group, fake_tensors
from repro_torch.models import xlstm

#: the reference's record keys (repro/launch/dryrun.py)
KEYS = {"arch", "shape", "kind", "mesh", "axes", "n_devices", "seq_len",
        "global_batch", "params_total", "params_active",
        "state_bytes_global", "state_bytes_per_device", "memory", "cost",
        "roofline", "lower_s", "compile_s"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_estimate"}
#: smoke cells: (seq, global batch, kind)
SMOKE_SHAPES = {"train": (16, 8, "train"), "prefill": (16, 8, "prefill"),
                "decode": (16, 8, "decode")}


@pytest.fixture(scope="module")
def group():
    """A fake group of 16 ranks, destroyed when the module's tests end,
    so none leaks into another file."""
    with fake_process_group(16):
        yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def mesh(group):
    """A fake 2 × 2 (data, model) mesh over the group's first 4 ranks."""
    return DeviceMesh("cpu", torch.arange(4).view(2, 2),
                      mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def mesh_2x8(group):
    """A fake 2 × 8 mesh: xlstm's 4 heads over its 8-way model axis."""
    return DeviceMesh("cpu", torch.arange(16).view(2, 8),
                      mesh_dim_names=("data", "model"))


@pytest.fixture
def smoke(monkeypatch):
    shapes = {**registry.SHAPES, **SMOKE_SHAPES}
    monkeypatch.setattr(registry, "SHAPES", shapes)
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: registry.get_config(arch, smoke=True))


@pytest.mark.parametrize("arch,kind", [
    ("granite-8b", "train"), ("granite-8b", "prefill"),
    ("granite-8b", "decode"), ("zamba2-1.2b", "prefill"),
    ("whisper-small", "prefill"), ("llava-next-34b", "prefill")])
def test_lower_cell_record(mesh, smoke, arch, kind):
    rec = dryrun.lower_cell(arch, kind, mesh,
                            microbatch=2 if kind == "train" else None)
    assert KEYS <= set(rec) and MEMORY == set(rec["memory"])
    assert rec["kind"] == kind and rec["n_devices"] == 4
    assert rec["state_bytes_per_device"] == rec["state_bytes_global"] // 4
    cfg = registry.get_config(arch, smoke=True)
    model = dryrun.model_flops(cfg, registry.input_specs(arch, kind,
                                                          cfg=cfg))
    ro = rec["roofline"]
    assert ro["model_flops"] == model
    # each device does at least its share of the step's products
    assert ro["flops"] * 4 >= model
    assert 0 < ro["useful_ratio"] <= 1
    mem = rec["memory"]
    assert mem["peak_estimate"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] >= rec["state_bytes_per_device"]


def test_whisper_decode_cell_traces(mesh, smoke):
    """Whisper's decode (self- and cross-attention against the cache)
    under the mesh: the record and the state per device."""
    rec = dryrun.lower_cell("whisper-small", "decode", mesh)
    assert KEYS <= set(rec) and rec["kind"] == "decode"
    assert rec["state_bytes_per_device"] == rec["state_bytes_global"] // 4
    assert rec["roofline"]["flops"] > 0


def test_failed_cell_writes_its_fail_file(mesh, smoke, tmp_path,
                                          monkeypatch):
    """A cell DTensor cannot trace records the op in ``<tag>.FAIL``, as
    the reference records its failures; the others go on.  The fault is
    planted: xlstm's log σ written with ``F.logsigmoid``, for which
    DTensor has no strategy."""
    monkeypatch.setattr(dryrun, "production_mesh",
                        lambda multi_pod=False: contextlib.nullcontext(mesh))
    monkeypatch.setattr(xlstm, "F", types.SimpleNamespace(
        **{**vars(F), "softplus": lambda x: -F.logsigmoid(-x)}))
    out = dryrun.run_cells([("xlstm-1.3b", "prefill", True, ""),
                            ("granite-8b", "long_500k", False, "skip")],
                           ["pod"], str(tmp_path), force=True)
    assert out == []
    fail = (tmp_path / "xlstm-1.3b__prefill__pod.FAIL").read_text()
    assert "in DTensor's aten.log_sigmoid_forward" in fail
    assert "sharding strategy" in fail


def _check_record(rec, kind, n_devices):
    assert KEYS <= set(rec) and MEMORY == set(rec["memory"])
    assert rec["kind"] == kind and rec["n_devices"] == n_devices
    assert rec["roofline"]["flops"] > 0
    mem = rec["memory"]
    assert mem["peak_estimate"] == mem["argument_bytes"] + mem["temp_bytes"]


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_cell_traces(mesh, smoke, arch, kind, grouped):
    """Both MoE dispatches under the mesh: the grouped one at g = 2 (the
    data axis), its scatter and gather on each rank's own groups; the
    flat one's scatter a partial sum over the data axis."""
    rec = dryrun.lower_cell(arch, kind, mesh, moe_grouped=grouped)
    _check_record(rec, kind, 4)
    # the scatter's partial sums are reduced over the data axis
    assert rec["comm_counts"].get("c10d_functional.all_reduce", 0) + \
        rec["comm_counts"].get("c10d_functional.reduce_scatter_tensor",
                               0) > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh_name", ["2x2", "2x8"])
def test_xlstm_cell_traces(request, smoke, mesh_name, kind):
    """xlstm's mLSTM and sLSTM blocks under the mesh: on 2 × 8 its 4
    heads do not divide the model axis, so they stay whole."""
    mesh = request.getfixturevalue(
        {"2x2": "mesh", "2x8": "mesh_2x8"}[mesh_name])
    rec = dryrun.lower_cell("xlstm-1.3b", kind, mesh)
    _check_record(rec, kind, mesh.size())


def test_tomo_transition_is_one_all_to_all(mesh):
    rec = lower_chain(mesh, n_angles=16, n_rows=8, n_det=32)
    assert rec["transitions"] == 1
    assert rec["comm_counts"] == {"_dtensor.shard_dim_alltoall": 1}
    coll = rec["roofline"]["coll_detail"]
    # the all-to-all moves the dataset's local bytes: (16, 8, 32) fp32
    # over the 2-way data axis
    assert coll["all-to-all"] == rec["local_dataset_bytes"] == \
        16 * 8 * 32 * 4 // 2
    assert sum(v for k, v in coll.items() if k != "all-to-all") == 0
    # the correction's and spectrum scale's work enter through cost()
    assert rec["roofline"]["flops"] > 0


def test_perf_records_a_failed_run_and_goes_on(mesh, tmp_path, monkeypatch):
    """A perf thread whose trace fails writes ``<name>.FAIL`` and the
    next thread runs, as in ``run_cells``."""
    monkeypatch.setattr(perf, "OUT", str(tmp_path))
    traced = []

    def lower(arch, shape, mesh, **knobs):
        traced.append(arch)
        raise RuntimeError(f"no sharding strategy for {arch}")

    monkeypatch.setattr(perf, "lower_cell", lower)
    perf.run_threads("all", mesh)
    assert traced[0] == "qwen3-moe-235b-a22b" and "granite-34b" in traced
    assert "llava-next-34b" in traced
    fail = (tmp_path / "A0_qwen3_train_flat.FAIL").read_text()
    assert "no sharding strategy for qwen3-moe-235b-a22b" in fail
    assert len(list(tmp_path.glob("*.FAIL"))) == len(traced)


@pytest.mark.parametrize("thread,names", [
    ("A", ["A0_qwen3_train_flat", "A1_qwen3_train_grouped",
           "A2_qwen3_train_grouped_nosp"]),
    ("A3", ["A3_qwen3_train_grouped_zero3gather"])])
def test_perf_thread_a_writes_its_records(mesh, tmp_path, monkeypatch,
                                          thread, names):
    """Thread A and A3 write the reference's records, with its knobs:
    flat, grouped, grouped without sequence parallelism, and A3."""
    monkeypatch.setattr(perf, "OUT", str(tmp_path))
    runs = []

    def lower(arch, shape, mesh, **knobs):
        runs.append(knobs)
        return {"arch": arch, "shape": shape, "memory": {"peak_estimate": 1},
                "roofline": {"compute_s": 1, "memory_s": 1,
                             "collective_s": 1, "bottleneck": "compute"}}

    monkeypatch.setattr(perf, "lower_cell", lower)
    perf.run_threads(thread, mesh)
    assert sorted(p.stem for p in tmp_path.glob("*.json")) == names
    assert not list(tmp_path.glob("*.FAIL"))
    assert [k.get("moe_grouped", False) for k in runs] == \
        [n != "A0_qwen3_train_flat" for n in names]
    assert [k.get("sp", True) for k in runs] == ["nosp" not in n
                                                 for n in names]


def test_fake_tensors_raises_naming_a_missing_dtensor_function(monkeypatch):
    """Without the function that makes a transition an all-to-all the
    dry-run refuses to run, rather than count an all-gather."""
    from torch.distributed.tensor import placement_types as pt
    monkeypatch.delattr(pt, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match="shard_dim_alltoall"):
        with fake_tensors():
            pass
