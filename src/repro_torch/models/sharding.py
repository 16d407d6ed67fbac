"""Logical-axis sharding for the LM substrate, built on core patterns.

The Savu insight — "data declares patterns; the framework derives
placement" — applied to model tensors: every weight/activation carries
*logical axes* (('batch','seq','embed'), ('embed','ffn'), …) and a rules
table maps logical axes -> mesh axes.  This module is the LM analogue of
the pattern placement and the single source of sharding truth for the
zoo.

Divisibility-aware: a logical axis only binds to a mesh axis when the
dimension divides the axis size (e.g. granite's single KV head never
shards over a 16-way model axis; it silently replicates instead, the
standard MQA fallback).

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names (the dim split over several mesh axes, major to minor),
or None (replicated).  :meth:`ShardingRules.placements` turns one into
DTensor placements on a ``DeviceMesh``.  The rules read only the mesh's
axis names and sizes, from a ``DeviceMesh`` (``mesh_dim_names``,
``shape``) or from any object with ``axis_names`` and ``devices.shape``.
With no mesh (the default rules) every constraint point of the models
returns its input itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

#: one entry per tensor dim: a mesh axis, several (major to minor), None
Spec = tuple  # tuple[str | tuple[str, ...] | None, ...]

# default rules: logical axis -> preferred mesh axis (None = replicate)
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    # activations
    "batch": ("pod", "data"),       # dp over pod×data jointly
    "seq": None,                    # sharded only in CP mode (see below)
    "seq_cp": "data",               # context-parallel prefill
    "seq_sp": "model",              # sequence-parallel residual stream
    #   (Korthikanti-style SP: the layer-scan carry/residual is sharded
    #   over the TP axis along seq; attention/mlp re-gather per shard.
    #   Auto-disabled for seq==1 (decode) by the divisibility gate.)
    "embed_act": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",              # cache seq dim: takes `model` when
    #   the kv-head dim can't (MQA/GQA with few heads) — split-K decode
    "ffn_act": "model",
    "vocab_act": "model",
    "expert_act": ("pod", "model"),
    # weights (2-D sharded: fsdp over data, tp over model)
    "embed": "data",                # fsdp shard of d_model weight dim
    "ffn": "model",
    "kv_embed": None,
    "vocab": "model",
    "expert": ("pod", "model"),     # expert parallelism
    "expert_ffn": None,
    "layers": None,                 # stacked-layer leading dim
    "state": None,                  # ssm / recurrent state dims
    "conv": None,
    "frames": None,
}


def mesh_axes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_placements(mesh: Any, spec: Spec) -> list:
    """DTensor placements on ``mesh`` for ``spec``: a tensor dim bound to
    several mesh axes is ``Shard(dim)`` on each, which DTensor orders as
    the mesh does (so the binding must name them in the mesh's order)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(order)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {names} is not in the mesh's "
                             f"axis order {tuple(order)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(x: torch.Tensor, mesh: Any, placements: list):
    """``x`` (a full tensor, real or fake) as a DTensor on ``mesh``: its
    local shard is this rank's slice; no collective runs."""
    from torch.distributed.tensor import DTensor, Shard
    rank = mesh.get_coordinate()
    local = x
    for mesh_dim, place in enumerate(placements):
        if isinstance(place, Shard):
            size = local.shape[place.dim] // mesh.size(mesh_dim)
            local = local.narrow(place.dim, rank[mesh_dim] * size, size)
    return DTensor.from_local(local.to(mesh.device_type).contiguous(), mesh,
                              placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


@dataclasses.dataclass
class ShardingRules:
    mesh: Any | None
    rules: dict[str, str | tuple[str, ...] | None]

    def spec(self, *logical_axes: str | None) -> Spec:
        """Spec for a tensor with the given logical axes.

        Each mesh axis may be used at most once per spec (XLA rule); later
        duplicates replicate instead.
        """
        names = mesh_axes(self.mesh) if self.mesh is not None else None
        used: set[str] = set()
        out = []
        for ax in logical_axes:
            m = self.rules.get(ax) if ax else None
            if m is None:
                out.append(None)
                continue
            cands = (m,) if isinstance(m, str) else tuple(m)
            cands = tuple(c for c in cands if names is None or c in names)
            cands = tuple(c for c in cands if c not in used)
            if not cands:
                out.append(None)
            elif len(cands) == 1:
                used.add(cands[0])
                out.append(cands[0])
            else:
                used.update(cands)
                out.append(cands)
        return tuple(out)

    def divisible_spec(self, shape: Sequence[int],
                       *logical_axes: str | None) -> Spec:
        """Allocation-aware spec: walk the dims in order, binding each
        logical axis's mesh axis only when (a) still unused and (b) the
        dim divides the axis extent.  A later dim can therefore pick up
        a mesh axis an earlier dim had to decline (e.g. the KV-cache seq
        dim takes ``model`` when kv_heads isn't divisible — MQA)."""
        if self.mesh is None:
            return self.spec(*logical_axes)
        sizes = mesh_axes(self.mesh)
        used: set[str] = set()
        out: list = []
        padded = tuple(logical_axes) + (None,) * (len(shape) -
                                                  len(logical_axes))
        for dim, ax in zip(shape, padded):
            m = self.rules.get(ax) if ax else None
            if m is None:
                out.append(None)
                continue
            cands = (m,) if isinstance(m, str) else tuple(m)
            cands = tuple(c for c in cands if c in sizes and c not in used)
            # try the full compound binding first, then single axes
            bound = None
            if len(cands) > 1:
                extent = 1
                for c in cands:
                    extent *= sizes[c]
                if dim % extent == 0:
                    bound = cands
            if bound is None:
                for c in cands:
                    if dim % sizes[c] == 0 and sizes[c] > 1:
                        bound = c
                        break
            if bound is None:
                out.append(None)
            else:
                out.append(bound)
                used.update((bound,) if isinstance(bound, str) else bound)
        return tuple(out)

    def placements(self, shape: Sequence[int], *logical_axes: str | None
                   ) -> list | None:
        """DTensor placements of a tensor of ``shape`` with these logical
        axes on the rules' mesh; None without a mesh."""
        if self.mesh is None:
            return None
        return spec_placements(self.mesh,
                               self.divisible_spec(shape, *logical_axes))

    def place(self, x: torch.Tensor, *logical_axes: str | None
              ) -> torch.Tensor:
        """A freshly made full tensor (a cache) placed by its logical axes
        when a mesh is active: a DTensor whose local shard is this rank's
        slice (no collective runs); ``x`` itself otherwise."""
        if self.mesh is None:
            return x
        return distribute(x, self.mesh, self.placements(x.shape,
                                                        *logical_axes))

    def constrain(self, x: torch.Tensor, *logical_axes: str | None,
                  shape: Sequence[int] | None = None) -> torch.Tensor:
        """``x`` redistributed to the placements its logical axes ask for
        when a mesh is active and ``x`` is a DTensor; ``x`` itself
        otherwise.  ``shape`` (default ``x.shape``) is the shape whose
        dims the divisibility gate reads: a (B, S, H·hd) projection is
        placed as its (B, S, H, hd) heads will be."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(
            self.mesh, self.placements(x.shape if shape is None else shape,
                                       *logical_axes))

    def pin(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` held to its own placements, so the backward hands its
        gradient back in them (a reshaped weight's gradient arrives
        placed before the reshape is undone); ``x`` itself when no mesh
        is active or ``x`` is no DTensor."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, x.placements)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_shards(fn, mesh: Any, args: tuple, in_placements: list,
              out_placements, in_grad_placements: list | None = None):
    """``fn`` run on each rank's local shards of the DTensors ``args``,
    each redistributed to its ``in_placements`` first; the output is
    placed by ``out_placements`` (``local_map``).  For work that is
    local to a shard by construction, for which DTensor has no strategy
    or would move data at every step.  ``in_grad_placements`` names the
    placements of an input's gradient where they are not its own (a
    replicated input whose local gradients are each rank's partial
    sum)."""
    from torch.distributed.tensor.experimental import local_map
    args = tuple(a.redistribute(mesh, p) for a, p in zip(args,
                                                         in_placements))
    return local_map(
        fn, out_placements=out_placements,
        in_placements=tuple(map(tuple, in_placements)),
        in_grad_placements=(None if in_grad_placements is None else
                            tuple(map(tuple, in_grad_placements))),
        device_mesh=mesh)(*args)


def make_rules(mesh: Any | None = None,
               overrides: Mapping[str, str | tuple[str, ...] | None] | None
               = None) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(mesh, rules)


# A module-level "current rules" the model code reads; the dry-run sets
# it under the production mesh, everything else leaves it at no-mesh
# (every constraint point returns its input).
_CURRENT = make_rules(None)


def set_rules(rules: ShardingRules) -> None:
    global _CURRENT
    _CURRENT = rules


def get_rules() -> ShardingRules:
    return _CURRENT


def sp_residual(x):
    """Sequence-parallel constraint for the residual stream / scan carry
    (B, S, d): batch->data, seq->model.  The saved per-layer carries are
    the dominant training-memory term; SP divides them by the TP size."""
    return get_rules().constrain(x, "batch", "seq_sp", "embed_act")


class use_rules:
    """Context manager: with use_rules(make_rules(mesh)): ..."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)
        return False
