"""Training checkpoints (``distributed.CheckpointManager``), the
straggler monitor, the train -> checkpoint -> restore -> serve loop and
``launch.train``'s kill and resume, on the CPU.  (The pipeline service's
checkpoint store is tests/test_torch_checkpoint.py.)"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import (CheckpointManager, StragglerEvent,
                                     StragglerMonitor)
from repro_torch.distributed.checkpoint import _leaves
from repro_torch.launch import train
from repro_torch.models import ModelConfig, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import (greedy_generate, init_training,
                                  make_train_step)


def _trainer(seed=0, moments="fp32"):
    cfg = get_config("granite-8b", smoke=True)
    model = build_model(cfg, "cpu", training=True)
    params, opt = init_training(model, torch.Generator().manual_seed(seed),
                                moments_dtype=moments)
    return model, params, opt


def _tree(rng):
    return {"a": torch.tensor(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "h": torch.tensor(rng.normal(size=(3,)),
                                         dtype=torch.bfloat16),
                       "q": torch.tensor([-127, 0, 5], dtype=torch.int8)},
            "list": [torch.zeros((), dtype=torch.int32)]}


def _flat(tree):
    return [t for _, t in _leaves(tree)]


def test_checkpoint_roundtrip(tmp_path, rng):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    cm.save(5, tree, extra={"note": "x"}, blocking=True)
    restored, man = cm.restore(_tree(np.random.default_rng(9)))
    assert man["step"] == 5 and man["extra"]["note"] == "x"
    assert man["treedef"] == ["a", "list/0", "nested/b", "nested/h",
                              "nested/q"]
    assert man["dtypes"][3] == "torch.bfloat16"
    assert np.load(tmp_path / "step_5" / "leaf_3.npy").dtype == np.uint16
    assert list(restored) == list(tree)
    assert isinstance(restored["list"], list)
    for a, b in zip(_flat(tree), _flat(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_module_and_optimizer_state(tmp_path):
    """A trainer's tree: the module's parameters are refilled in place
    (still tracking gradients), int8 moments keep their codes."""
    _, params, opt = _trainer(0, "int8")
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, {"params": params, "opt": opt}, blocking=True)
    _, fresh, fresh_opt = _trainer(1, "int8")
    restored, man = cm.restore({"params": fresh, "opt": fresh_opt})
    assert restored["params"] is fresh
    assert "params/layers.0.attn.wq" in man["treedef"]
    assert "opt/m/embed/q" in man["treedef"] and "opt/step" in man["treedef"]
    for (n, a), b in zip(params.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b) and b.requires_grad, n
    assert restored["opt"]["m"]["embed"]["q"].dtype == torch.int8


def test_checkpoint_retention_and_latest(tmp_path, rng):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(rng), blocking=True)
    assert cm.steps() == [3, 4]
    assert cm.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


def test_checkpoint_async_saves_host_copies(tmp_path, rng):
    """``save`` returns before the files are written, with copies taken:
    updating the tensors in place afterwards changes nothing saved."""
    cm = CheckpointManager(str(tmp_path))
    tree = _tree(rng)
    want = tree["a"].clone()
    cm.save(1, tree)
    tree["a"].add_(1.0)
    cm.wait()
    assert cm.latest_step() == 1
    restored, _ = cm.restore(_tree(rng))
    assert torch.equal(restored["a"], want)


def test_checkpoint_writer_error_raised_by_wait(tmp_path, rng, monkeypatch):
    cm = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken)
    cm.save(1, _tree(rng))
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.steps() == []                 # nothing half-written published


def test_checkpoint_incompatible_tree_rejected(tmp_path, rng):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _tree(rng), blocking=True)
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"only": torch.zeros(2)})
    bad = _tree(rng)
    bad["nested"]["z"] = bad["nested"].pop("q")
    with pytest.raises(ValueError, match="'nested/q'"):
        cm.restore(bad)
    bad = _tree(rng)
    bad["a"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match=r"shape \(8, 4\)"):
        cm.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(bad)


def test_checkpoint_restore_takes_template_dtype_and_device(tmp_path, rng):
    cm = CheckpointManager(str(tmp_path))
    tree = _tree(rng)
    cm.save(1, tree, blocking=True)
    tmpl = _tree(rng)
    tmpl["a"] = tmpl["a"].double()
    restored, _ = cm.restore(tmpl, device="cpu")
    assert restored["a"].dtype == torch.float64
    assert torch.equal(restored["a"].float(), tree["a"])
    assert restored["nested"]["h"].dtype == torch.bfloat16


def test_lifecycle_train_checkpoint_restore_serve(tmp_path):
    """Train a small LM, checkpoint, restore into fresh weights, serve
    from them; the next step's loss agrees with the originals'."""
    cfg = ModelConfig(arch_id="life", family="dense", n_layers=2,
                      d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab=64, dtype=torch.float32, remat=False)
    model = build_model(cfg, "cpu", training=True)
    params, opt = init_training(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=5e-3, warmup_steps=1,
                                              total_steps=40))
    toks = np.random.default_rng(0).integers(0, 64, (4, 16)
                                             ).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in range(6):
        params, opt, metrics = step(params, opt, batch)
        if s % 3 == 2:
            cm.save(s, {"params": params, "opt": opt},
                    extra={"loss": float(metrics["loss"])}, blocking=True)
    fresh, fresh_opt = init_training(model, torch.Generator().manual_seed(7))
    restored, man = cm.restore({"params": fresh, "opt": fresh_opt})
    assert man["step"] == 5 and cm.steps() == [2, 5]
    out = greedy_generate(model, restored["params"], {"tokens": toks},
                          max_new=4, max_len=24)
    assert out.shape == (4, 4)
    np.testing.assert_array_equal(
        out, greedy_generate(model, params, {"tokens": toks}, max_new=4,
                             max_len=24))
    _, _, m1 = step(params, opt, batch)
    _, _, m2 = step(restored["params"], restored["opt"], batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5


def _final_leaves(d):
    step = max(int(n.split("_")[1]) for n in os.listdir(d)
               if n.startswith("step_"))
    path = os.path.join(d, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as fh:
        n = json.load(fh)["n_leaves"]
    return step, [np.load(os.path.join(path, f"leaf_{i}.npy"))
                  for i in range(n)]


def test_launch_train_resumed_equals_uninterrupted(tmp_path, monkeypatch,
                                                   capsys):
    """Run A trains 8 steps; run B is the same command, killed once
    step_3 is published, then run again: it resumes at step 4 and ends
    with A's checkpoint, bit for bit."""
    args = ["--smoke", "--steps", "8", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "4", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(args + ["--ckpt-dir", a])["start"] == 0
    real = CheckpointManager.save

    def save_then_die(self, step, tree, **kw):
        real(self, step, tree, **kw)
        if step == 3:
            self.wait()
            raise KeyboardInterrupt("killed after step_3 was published")

    monkeypatch.setattr(CheckpointManager, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        train.main(args + ["--ckpt-dir", b])
    monkeypatch.undo()
    assert CheckpointManager(b).latest_step() == 3
    capsys.readouterr()
    summary = train.main(args + ["--ckpt-dir", b])
    out = capsys.readouterr().out
    assert summary["start"] == 4 and "resumed from step 3" in out
    assert "step     7  loss=" in out and summary["device"] == "cpu"
    sa, la = _final_leaves(a)
    sb, lb = _final_leaves(b)
    assert sa == sb == 7 and len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_launch_train_smoke_flag_is_optional():
    """The reference's --smoke is store_true with default True, so the
    full config can never be asked for; the port's takes --no-smoke."""
    assert train.parse_args([]).smoke is True
    assert train.parse_args(["--no-smoke"]).smoke is False
    assert train.parse_args([]).device == "cuda"


# ------------------------------------------------------------ straggler
def test_straggler_detection_and_eviction():
    warns, evicts = [], []
    m = StragglerMonitor(window=16, factor=2.0, patience=2,
                         on_warn=warns.append, on_evict=evicts.append)
    for i in range(8):
        m.observe(i, 1.0)
    m.observe(8, 3.0)        # warn
    m.observe(9, 3.5)        # evict (2 consecutive)
    assert len(warns) == 1 and len(evicts) == 1
    assert isinstance(evicts[0], StragglerEvent) and evicts[0].ratio >= 2.0


def test_straggler_recovers():
    m = StragglerMonitor(window=16, factor=2.0, patience=3)
    for i in range(8):
        m.observe(i, 1.0)
    m.observe(8, 5.0)
    m.observe(9, 1.0)        # back to normal resets patience
    assert m._consecutive == 0


def test_straggler_timer_interface():
    m = StragglerMonitor()
    m.start_step(1)
    assert m.end_step(wall=0.01) is None


def test_checkpoint_elastic_reshard_matches_reference(tmp_path, rng):
    """Restore with explicit placements on a mesh (the elastic restart
    path) gives the reference's values, leaf for leaf."""
    import socket

    import jax
    import torch.distributed as dist
    from jax.sharding import NamedSharding, PartitionSpec
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro.distributed import CheckpointManager as JaxCheckpointManager
    from repro_torch.distributed import param_shardings, replicated

    a = rng.normal(size=(8, 4)).astype(np.float32)
    b = np.arange(10, dtype=np.int32)
    jmesh = jax.make_mesh((1,), ("data",),
                          axis_types=(jax.sharding.AxisType.Auto,))
    jtree = {"a": jax.numpy.asarray(a), "nested": {"b": jax.numpy.asarray(b)}}
    jcm = JaxCheckpointManager(str(tmp_path / "jax"))
    jcm.save(1, jtree, blocking=True)
    want, _ = jcm.restore(jtree, shardings=jax.tree.map(
        lambda _: NamedSharding(jmesh, PartitionSpec()), jtree))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        tree = {"a": torch.from_numpy(a), "nested": {"b": torch.from_numpy(b)}}
        cm = CheckpointManager(str(tmp_path / "torch"))
        cm.save(1, tree, blocking=True)
        got, _ = cm.restore(tree, mesh=mesh,
                            shardings=replicated(dict(_leaves(tree)), mesh))
        for path, x in _leaves(got):
            assert isinstance(x, DTensor), path
        np.testing.assert_array_equal(got["a"].to_local().numpy(),
                                      np.asarray(want["a"]))
        np.testing.assert_array_equal(got["nested"]["b"].to_local().numpy(),
                                      np.asarray(want["nested"]["b"]))
        # a module refilled in place takes param_shardings' placements
        lin = torch.nn.Linear(4, 8)
        cm.save(2, lin, blocking=True)
        fresh = torch.nn.Linear(4, 8)
        cm.restore(fresh, mesh=mesh, shardings=param_shardings(fresh, mesh))
        assert isinstance(fresh.weight, torch.nn.Parameter)
        assert isinstance(fresh.weight.data, DTensor)
        assert torch.equal(fresh.weight.to_local(), lin.weight.detach())
        with pytest.raises(ValueError, match="mesh"):
            cm.restore(fresh, shardings=param_shardings(fresh, mesh))
    finally:
        dist.destroy_process_group()
