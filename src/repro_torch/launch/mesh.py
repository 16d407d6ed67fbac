"""Production mesh construction.

FUNCTIONS, not module-level constants: importing this module sets no
environment variable and starts no process group.  The production
meshes are ``DeviceMesh``es over a *fake* process group (this process
is rank 0 of 256 or 512), so a dry-run can walk fake tensors through
DTensor's sharding propagation and collectives on one host;
:func:`production_mesh` opens the group and destroys it on exit.

The fake meshes and tensors carry the host's device type, "cpu", not the
card's: a CPU-only torch cannot run autograd on a fake CUDA leaf (it has
no CUDA device guard), nor copy a fake tensor to CUDA.  What the dry-run
counts (shapes, dtypes, ops, collectives) does not depend on it.  Two
things do, and :func:`fake_tensors` sets them right: DTensor sends a
shard-to-shard transition on a "cpu" mesh through an all-gather (gloo
has no all-to-all), where the cards run an all-to-all; and
FakeTensorMode runs a real kernel for a boolean-mask ``index_put_``
(data-dependent), where the mask's ``masked_fill_`` does the same.

The fake backend lives in a private module of torch
(``torch.testing._internal.distributed.fake_pg``); it is imported here
and nowhere else.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

from ..device import resolve_device

#: the device type of the fake meshes and of the dry-run's fake tensors
DEVICE_TYPE = "cpu"


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(
            "the production mesh needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg: FakeStore and "
            "the 'fake' backend), which this torch does not have") from e
    return FakeStore()


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing.  Destroyed on
    exit, so no group outlives the block."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake one would replace it")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=_fake_store())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _production_layout(multi_pod: bool
                       ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 single-pod (256 cards) or 2×16×16 two-pod (512 cards),
    over the default process group, which must be that size (open one
    with :func:`fake_process_group`, or use :func:`production_mesh`)."""
    shape, axes = _production_layout(multi_pod)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"make_production_mesh needs a process group of {n} ranks; "
            f"open one with `with fake_process_group({n}):` or use "
            f"`with production_mesh(multi_pod={multi_pod}) as mesh:`")
    return init_device_mesh(DEVICE_TYPE, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """The production mesh over a fake process group that is destroyed
    when the block ends."""
    shape, _ = _production_layout(multi_pod)
    n = 1
    for s in shape:
        n *= s
    with fake_process_group(n):
        yield make_production_mesh(multi_pod=multi_pod)


def make_host_mesh(device: str | torch.device = "cuda") -> DeviceMesh:
    """The real devices of the initialised process group as (n, 1) with
    axes ("data", "model"): one rank per card on the card (raises without
    one), or gloo ranks when the caller asks for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (one rank per device)")
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


class _FakeOps(TorchDispatchMode):
    """Beneath DTensor (it defers every op on a DTensor): a boolean-mask
    ``index_put_`` of one value (DTensor's masked vocab-parallel
    embedding) becomes the mask's ``masked_fill_``, whose output shape
    follows from its inputs, so FakeTensorMode runs no real kernel."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented
        if func is torch.ops.aten.index_put_.default:
            x, indices, values = args[:3]
            accumulate = kwargs.get("accumulate",
                                    args[3] if len(args) > 3 else False)
            if (len(indices) == 1 and indices[0] is not None
                    and indices[0].dtype == torch.bool
                    and not accumulate and values.numel() == 1):
                mask = indices[0]
                mask = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
                return x.masked_fill_(mask, values)
        return func(*args, **kwargs)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard transition as the all-to-all op the
    cards run, whatever the mesh's device type (the op's meta function
    gives the fake output; no collective runs under fake tensors)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _on_host(fn):
    """``fn`` run with every dispatch mode off, for DTensor's metadata
    work, which is no part of the step: it sizes a strided shard from a
    real index tensor (``arange`` of the dim, then ``tolist``), which a
    fake tensor cannot give, and learns an op's output metadata by
    running the op at its global shapes (under a fake-tensor mode of its
    own), which no reader of the step may see."""
    def wrapped(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def fake_tensors() -> Iterator[None]:
    """Fake tensors (shapes, dtypes and devices, no storage): what the
    dry-runs trace under.  Allocates nothing; a shard-to-shard
    redistribution inside is DTensor's all-to-all.  It reroutes three
    private DTensor functions and raises, naming the function, on a
    torch that lacks one: without them a transition would be counted as
    an all-gather or a trace would fail."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    patches = [(pt, "shard_dim_alltoall", lambda _: _shard_dim_alltoall),
               (pt._StridedShard, "local_shard_size_and_offset", _on_host),
               (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                _on_host)]
    for obj, name, _ in patches:
        if name not in vars(obj):
            where = (obj.__name__ if inspect.ismodule(obj)
                     else f"{obj.__module__}.{obj.__qualname__}")
            raise RuntimeError(
                f"the dry-run reroutes {where}.{name}, which this torch "
                f"({torch.__version__}) does not have")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for (obj, name, old), (_, _, wrap) in zip(saved, patches):
        setattr(obj, name, wrap(old))
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), _FakeOps():
            yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
