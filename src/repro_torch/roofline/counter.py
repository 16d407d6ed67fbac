"""Per-device work of a block of PyTorch code: the port's counterpart of
the reference's HLO cost model (``repro/roofline/hlo_cost.py``).

The port has no HLO: :class:`Counter` is a dispatch mode that sees every
op the block runs and counts, per device,

  * flops by ``torch.utils.flop_counter``'s formulas (a product's
    2·m·n·k, as the reference counts its dots);
  * bytes ≈ 2 · Σ |op results| (write + one read), the reference's
    definition: views and metadata move nothing and are skipped, and an
    in-place update of part of a tensor (``index_put_``, ``scatter_``,
    ``index_copy_``, ``copy_`` into a slice) counts the update, not the
    tensor it lands in;
  * collective bytes by type, each collective's output bytes (the
    reference's convention; an all-reduce is weighted 2× when summed,
    its reduce-scatter and all-gather phases), from the
    ``_c10d_functional`` ops and DTensor's ``_dtensor`` all-to-all;
  * a hand-written kernel's work through ``kernels/tally.py``'s
    ``cost()``: a launch notes it, and a plain version runs inside
    ``tally.plain_version``, whose ops the counter skips.

Per device: the counter defers every op on a DTensor, so it sits beneath
DTensor and sees the ops on the local shards and the collectives that
DTensor inserts (DTensor's own metadata runs at global shapes are hidden
from it by ``launch.mesh.fake_tensors``).  Python loops unroll, so trip
counts come for free.
"""
from __future__ import annotations

import collections
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import tally

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_aten = torch.ops.aten
#: in-place updates of part of a tensor: (op, index of the update arg)
_PARTIAL_UPDATES = {
    _aten.index_put_.default: 2,
    _aten.index_copy_.default: 3,
    _aten.index_add_.default: 3,
    _aten.scatter_.src: 3,
    _aten.scatter_add_.default: 3,
    _aten.masked_scatter_.default: 2,
}
#: ops that allocate or describe and move no data
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.empty_like.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default,
}


def _nbytes(t: Any) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def shape_key(t: torch.Tensor) -> str:
    """``dtype[d0,d1,...]`` as the reference's HLO names a shape."""
    dt = str(t.dtype).replace("torch.", "")
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


class Counter(TorchDispatchMode):
    """``with Counter() as c: ...`` -> ``c.flops``, ``c.bytes``,
    ``c.coll`` (type -> output bytes), ``c.coll_ops`` ((type, shape) ->
    output bytes), ``c.collective_bytes`` (weighted), per device."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll_ops: collections.Counter = collections.Counter()
        self.n_collectives = 0
        #: the last op handed to DTensor (the one a DTensor failure is in)
        self.last_dtensor_op = None
        self._tally = None

    @property
    def collective_bytes(self) -> float:
        return float(sum(v * (2 if k == "all-reduce" else 1)
                         for k, v in self.coll.items()))

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "coll_detail": dict(self.coll),
                "n_collectives": self.n_collectives}

    def __enter__(self):
        self._tally_cm = tally.tally(costs=True)
        self._tally = self._tally_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tally_cm.__exit__(*exc)
            self.flops += self._tally.flops
            self.bytes += self._tally.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            self.last_dtensor_op = func
            return NotImplemented
        out = func(*args, **kwargs)
        if tally.in_plain_version():
            return out
        name = str(func.overloadpacket)
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.coll[coll] += _nbytes(t)
                    self.coll_ops[(coll, shape_key(t))] += _nbytes(t)
            self.n_collectives += 1
            return out
        if name.startswith(("_c10d_functional.", "c10d.", "prim.")):
            return out                  # waits and process-group metadata
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        self.bytes += 2 * self._traffic(func, args, out)
        return out

    @staticmethod
    def _traffic(func, args, out) -> int:
        if func.is_view or func in _NO_TRAFFIC:
            return 0
        if func in _PARTIAL_UPDATES:
            return _nbytes(args[_PARTIAL_UPDATES[func]])
        return sum(_nbytes(t) for t in tree_leaves(out))
