"""The port's sharding rules (models/sharding.py,
distributed/param_sharding.py) against the JAX package's, and DTensor
placement on the fake production meshes (launch/mesh.py)."""
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.tree_util import tree_flatten_with_path

import repro.distributed.param_sharding as jps
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.sharding import make_rules as jax_rules

from repro_torch.configs import get_config
from repro_torch.distributed.param_sharding import (batch_specs,
                                                    distribute_params,
                                                    param_specs,
                                                    reference_leaves)
from repro_torch.launch.mesh import (fake_process_group, fake_tensors,
                                     make_production_mesh, production_mesh)
from repro_torch.models import build_model
from repro_torch.models.sharding import DEFAULT_RULES, get_rules, make_rules


@pytest.fixture(scope="module", autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


class StandIn:
    """A mesh as the rules read it: axis names and a devices array."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"1": StandIn((1,), ("data",)),
          "pod": StandIn((16, 16), ("data", "model")),
          "pod2": StandIn((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = sorted(DEFAULT_RULES)
#: multi-axis specs of the models' constraint points
POINTS = [("batch", "seq", "embed_act"), ("batch", "seq_sp", "embed_act"),
          ("batch", "seq", "heads", None), ("batch", "seq", "kv_heads", None),
          ("layers", "batch", "kv_heads", "kv_seq", None),
          ("batch", "kv_heads", "kv_seq", None), ("expert_act", None, None),
          ("batch", "seq", "vocab_act"), ("batch", "seq", "ffn_act"),
          ("vocab", "embed_act"), ("batch", None, "heads", None)]
SHAPES = [(8,), (16,), (48,), (256,), (4096,), (8, 16), (32, 4096, 4096),
          (256, 4096, 8, 128), (36, 128, 8, 32768, 128), (128, 4, 4096)]


def _norm(spec):
    """A spec as a tuple, one-axis tuples as the axis name."""
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_and_divisible_spec_equal_reference(mesh):
    m = MESHES[mesh]
    ours, ref = make_rules(m), jax_rules(m)
    cases = [(ax,) for ax in LOGICAL] + POINTS + \
        list(itertools.permutations(("batch", "heads", "kv_seq"), 3))
    for axes in cases:
        assert _norm(ours.spec(*axes)) == _norm(tuple(ref.spec(*axes))), axes
        for shape in SHAPES:
            if len(shape) < len(axes):
                continue
            got = ours.divisible_spec(shape, *axes)
            want = tuple(ref.divisible_spec(shape, *axes))
            assert _norm(got) == _norm(want), (axes, shape)


def test_rules_divisibility_gate():
    r = make_rules(MESHES["1"])
    # size-1 mesh axes never shard
    assert r.divisible_spec((8, 16), "batch", "ffn") == (None, None)


def test_rules_kv_seq_fallback():
    """Without a mesh spec keeps the declared preferences: `model` is
    consumed once, by the kv heads."""
    ours = make_rules(None).spec("batch", "kv_heads", "kv_seq", None)
    ref = jax_rules(None).spec("batch", "kv_heads", "kv_seq", None)
    assert ours[1] == "model" and ours[2] is None
    assert _norm(ours) == _norm(tuple(ref))
    # on the production mesh the cache's seq dim takes `model` when 8 kv
    # heads cannot
    r = make_rules(MESHES["pod"])
    assert r.divisible_spec((128, 8, 32768, 128), "batch", "kv_heads",
                            "kv_seq", None) == ("data", None, "model", None)


def _jax_specs(shapes, mesh, mode, monkeypatch):
    """path -> (stacked shape, spec) of every leaf of the reference's
    tree of ``shapes``, through its own param_shardings (its
    NamedSharding read back as the spec: the stand-in mesh has no
    devices)."""
    monkeypatch.setattr(jps, "NamedSharding", lambda _mesh, spec: spec)
    specs = jps.param_shardings(shapes, mesh, mode)
    out = {}
    for (path, leaf), (_, spec) in zip(
            tree_flatten_with_path(shapes)[0],
            tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(
                s, jax.sharding.PartitionSpec))[0]):
        names = tuple(jps._key_name(k) for k in path)
        out[names] = (tuple(leaf.shape), tuple(spec))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_every_leaf(arch, monkeypatch):
    with fake_tensors():
        module = build_model(get_config(arch), "cpu").init(
            torch.Generator("cpu"))
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    leaves = list(reference_leaves(module))
    assert len(leaves) == len(shapes)
    jax_shapes = jax.eval_shape(jax_build(jax_config(arch)).init,
                                jax.random.key(0))
    for mesh_name in ("pod", "pod2"):
        m = MESHES[mesh_name]
        for mode in ("train", "serve"):
            ref = _jax_specs(jax_shapes, m, mode, monkeypatch)
            ours = param_specs(module, m, mode)
            seen = set()
            for name, path, stack in leaves:
                want_shape, want = ref[path]
                assert want_shape == stack + shapes[name], (name, path)
                want = want + (None,) * (len(want_shape) - len(want))
                assert _norm(ours[name]) == _norm(want[len(stack):]), \
                    (mesh_name, mode, name, path)
                seen.add(path)
            assert seen == set(ref)


def test_batch_shardings_equal_reference(monkeypatch):
    monkeypatch.setattr(jps, "NamedSharding", lambda _mesh, spec: spec)
    batch = {"tokens": (256, 4096), "labels": (256, 4096),
             "patches": (256, 2048, 7168), "token": (128, 1), "one": (1,),
             "odd": (24, 8)}
    for m in MESHES.values():
        ref = jps.batch_shardings(
            {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in batch.items()},
            m)
        ours = batch_specs(batch, m)
        for k in batch:
            want = tuple(ref[k])
            want += (None,) * (len(batch[k]) - len(want)) if want else ()
            assert _norm(ours[k]) == _norm(want), (k, m.axis_names)


@pytest.mark.parametrize("multi_pod,arch", [(False, "granite-8b"),
                                            (True, "qwen3-moe-235b-a22b")])
def test_distribute_params_local_shards(multi_pod, arch):
    with production_mesh(multi_pod=multi_pod) as mesh, fake_tensors():
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        module = build_model(get_config(arch), "cpu").init(
            torch.Generator("cpu"))
        global_shapes = {n: tuple(p.shape)
                         for n, p in module.named_parameters()}
        specs = param_specs(module, mesh)
        distribute_params(module, mesh)
        compound = 0
        for name, p in module.named_parameters():
            want = list(global_shapes[name])
            for d, ax in enumerate(specs[name]):
                names = () if ax is None else (
                    (ax,) if isinstance(ax, str) else ax)
                compound += len(names) > 1
                for a in names:
                    want[d] //= sizes[a]
            assert tuple(p.to_local().shape) == tuple(want), name
        # qwen3's 128 experts split over pod × model on the two-pod mesh
        assert (compound > 0) == multi_pod
        # a compound ("pod", "data") binding: the batch over 2 × 16
        r = make_rules(mesh)
        x = r.place(torch.zeros(256, 64), "batch", None)
        if multi_pod:
            assert r.divisible_spec((256, 64), "batch", None) == \
                (("pod", "data"), None)
            assert tuple(x.to_local().shape) == (256 // 32, 64)
        else:
            assert tuple(x.to_local().shape) == (256 // 16, 64)


def test_production_mesh_needs_its_group_and_leaves_none():
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with production_mesh() as mesh:
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True)
        assert tuple(mesh.shape) == (2, 16, 16)
    assert not dist.is_initialized()


def test_constrain_returns_its_input_without_a_mesh():
    r = get_rules()
    assert r.mesh is None
    x = torch.randn(2, 3, 4)
    assert r.constrain(x, "batch", "seq", "embed_act") is x
    assert r.place(x, "batch", "seq", "embed_act") is x
    assert r.pin(x) is x
    with production_mesh() as mesh:
        # a plain tensor is left alone under a mesh too
        assert make_rules(mesh).constrain(x, "batch", "seq", None) is x
        assert make_rules(mesh).pin(x) is x


def test_models_on_a_gloo_mesh_equal_one_device():
    """The port's models under a real 2 × 2 (and 1 × 4) mesh of 4 gloo
    ranks compute what they compute on one device: both MoE dispatches'
    loss and gradients, the decode step with the kv heads or the cache's
    sequence split, and xlstm's loss and gradients
    (``torch_mesh_worker``)."""
    import socket

    import torch.multiprocessing as mp

    import torch_mesh_worker
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_mesh_worker.run, args=(port,), nprocs=4)
