"""One rank of ``test_torch_sharding.py::test_models_on_a_gloo_mesh_
equal_one_device``: the port's models under a real 4-rank gloo mesh
against the same models on one device.  A module of its own, so the
spawned ranks import torch and the port only.

Each rank checks, raising on a difference:

- qwen3-moe's smoke loss and every gradient on the 2 × 2 (data, model)
  mesh, with the flat dispatch and the grouped one (g = 2, the data
  axis; one device pins the group count to 2);
- granite-8b's smoke decode step against a filled cache, on 2 × 2 (the
  kv heads split over model) and on 1 × 4 (the cache split along its
  sequence: split-K decode);
- xlstm's smoke loss and every gradient on 2 × 2 (the mLSTM's and
  sLSTM's scans on each rank's shards).
"""
import copy
import dataclasses

import torch
import torch.distributed as dist

#: loss and gradient tolerances (fp32 smoke configs; the mesh sums in
#: another order)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _train_check(arch, mesh, cfg_fields=None, groups=None):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, smoke_batch
    from repro_torch.distributed.param_sharding import (batch_shardings,
                                                        distribute_params)
    from repro_torch.models import build_model, make_rules, moe, use_rules
    from repro_torch.models.sharding import distribute

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **(cfg_fields or {}))
    model = build_model(cfg, "cpu", training=True)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in smoke_batch(cfg, batch=4, seq=8).items()}
    mesh_params = copy.deepcopy(params)
    real = moe._dp_extent
    if groups:
        moe._dp_extent = lambda r: groups
    try:
        want = model.loss(params, batch)
        want.backward()
    finally:
        moe._dp_extent = real
    distribute_params(mesh_params, mesh, "train")
    sh = batch_shardings({k: v.shape for k, v in batch.items()}, mesh)
    with use_rules(make_rules(mesh)), implicit_replication():
        got = model.loss(mesh_params, {k: distribute(v, mesh, sh[k])
                                       for k, v in batch.items()})
        got.backward()
    torch.testing.assert_close(got.full_tensor(), want, **LOSS_TOL)
    grads = dict(params.named_parameters())
    for name, p in mesh_params.named_parameters():
        torch.testing.assert_close(
            p.grad.full_tensor(), grads[name].grad, **GRAD_TOL,
            msg=lambda m, name=name: f"{arch} {cfg_fields} {name}: {m}")


def _decode_check(mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distributed.param_sharding import (batch_shardings,
                                                        distribute_params)
    from repro_torch.models import build_model, make_rules, use_rules
    from repro_torch.models.sharding import distribute

    cfg = get_config("granite-8b", smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    cache = {k: (torch.randn(v.shape, generator=g).to(v.dtype)
                 if isinstance(v, torch.Tensor) else 5)
             for k, v in model.init_cache(4, 16).items()}
    token = torch.arange(1, 5, dtype=torch.int32)[:, None]
    want, want_cache = model.decode_step(params, token, copy.deepcopy(cache))
    mesh_params = distribute_params(copy.deepcopy(params), mesh, "serve")
    with use_rules(make_rules(mesh)) as r, implicit_replication():
        placed = {k: (r.place(v, "layers", "batch", "kv_heads", "kv_seq",
                              None) if isinstance(v, torch.Tensor) else v)
                  for k, v in cache.items()}
        got, got_cache = model.decode_step(
            mesh_params, distribute(token, mesh, batch_shardings(
                {"t": token.shape}, mesh)["t"]), placed)
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-4,
                               atol=1e-5)
    # the new slot written where it lives
    for k in ("k", "v"):
        torch.testing.assert_close(got_cache[k].full_tensor(),
                                   want_cache[k], rtol=1e-5, atol=1e-6)


def run(rank: int, port: int) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        _train_check("qwen3-moe-235b-a22b", mesh)
        _train_check("qwen3-moe-235b-a22b", mesh, {"moe_grouped": True},
                     groups=2)
        _decode_check(mesh)
        _decode_check(init_device_mesh("cpu", (1, 4),
                                       mesh_dim_names=("data", "model")))
        _train_check("xlstm-1.3b", mesh)
    finally:
        dist.destroy_process_group()
