"""Parameter/cache sharding assignment for the production mesh.

Name-aware rules for the known module layouts (attention, MLP, MoE,
embeddings, SSM) with a generic largest-dims fallback, all divisibility-
checked.  The result places the dry-run's parameters as DTensors;
moments inherit parameter placements by construction.

The reference stacks each layer leaf over its layers on leading dims
(``layers`` (G, ...), Zamba2's ``groups`` (G, k, ...)) and assigns the
spec of the stacked leaf; the port keeps one module per layer.  So a
port leaf's spec is the reference's spec of the stacked leaf with the
stacked dims dropped: :func:`reference_leaves` gives each port leaf its
reference path and stacked extents, and the rules see the stacked shape.
The rules count from the trailing dims, so the stacked dims replicate
apart from the two cases where the reference's rules reach them (a
shared expert MLP under ``moe``, and the largest-dims fallback of a
stacked norm scale); there the port's spec is what the reference's is
on the layer's own dims.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
from torch import nn

from ..models.sharding import Spec, distribute, mesh_axes, spec_placements

# name -> per-dim logical spec, counted FROM THE TRAILING dims (stacked
# layer dims in front are replicated automatically).
_NAME_RULES: dict[str, tuple[str | None, ...]] = {
    "embed": ("model", "data"),            # (vocab, d_model)
    "unembed": ("model", "data"),
    "wq": ("data", "model", None),         # (d, H, hd)
    "wk": ("data", "model", None),         # kv heads: divisibility-gated
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),         # (H, hd, d)
    "w_up": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_down": ("model", "data"),
    "router": ("data", None),              # (d, E): replicate experts dim
    "w_in": ("data", "model"),             # mamba in-proj
    "w_out": ("model", "data"),
    "w_if": ("data", "model"),
    "w_o": ("data", "model"),
    "w_gates": ("data", "model"),
    "r_gates": (None, None, None),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
}
# MoE stacked expert weights: (E, d, ff) / (E, ff, d) — expert dim first
_MOE_RULES = {
    "w_gate": (("pod", "model"), "data", None),
    "w_up": (("pod", "model"), "data", None),
    "w_down": (("pod", "model"), None, "data"),
}


def _axis_size(mesh: Any, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _gate(mesh: Any, dim: int, axis: str | None) -> str | None:
    if axis is None or axis not in mesh_axes(mesh):
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def spec_for(path: tuple[str, ...], shape: tuple[int, ...], mesh: Any
             ) -> Spec:
    """The spec of a leaf at ``path`` (its names, outermost first) with
    ``shape``, as the reference assigns it."""
    names = [str(k) for k in path]
    leaf = names[-1] if names else ""
    in_moe = "moe" in names
    rules = None
    if in_moe and leaf in _MOE_RULES:
        rules = _MOE_RULES[leaf]
    elif leaf in _NAME_RULES:
        rules = _NAME_RULES[leaf]
    axes = mesh_axes(mesh)

    nd = len(shape)
    spec: list = [None] * nd
    if rules is not None and nd >= len(rules):
        off = nd - len(rules)
        used = set()
        for i, want in enumerate(rules):
            if isinstance(want, tuple):
                cands = tuple(c for c in want if c in axes and c not in used)
                extent = 1
                for c in cands:
                    extent *= _axis_size(mesh, c)
                if cands and extent > 1 and shape[off + i] % extent == 0:
                    spec[off + i] = cands if len(cands) > 1 else cands[0]
                    used.update(cands)
                continue
            ax = _gate(mesh, shape[off + i], want)
            if ax and ax not in used:
                spec[off + i] = ax
                used.add(ax)
        return tuple(spec)

    # fallback: shard the two largest trailing dims over data, then model
    order = sorted(range(nd), key=lambda i: -shape[i])
    used = set()
    for i in order:
        if shape[i] < 2:
            continue
        for ax in ("data", "model"):
            if ax in used:
                continue
            if _gate(mesh, shape[i], ax):
                spec[i] = ax
                used.add(ax)
                break
        if len(used) == 2:
            break
    return tuple(spec)


def _period(layers: nn.ModuleList) -> int:
    """Sub-layers a group of the LM's ``layers`` holds: the shortest
    period of its sequence of FFN kinds (llama4's dense/MoE alternation
    is 2, every other config 1)."""
    from ..models.moe import MoE
    kinds = [isinstance(b.ffn, MoE) for b in layers]
    for g in range(1, len(kinds) + 1):
        if len(kinds) % g == 0 and kinds == kinds[:g] * (len(kinds) // g):
            return g
    return len(kinds)


def reference_leaves(module: nn.Module
                     ) -> Iterator[tuple[str, tuple[str, ...],
                                         tuple[int, ...]]]:
    """(port name, reference path, stacked extents) of every parameter:
    the path the reference's tree gives the leaf (a Block's ``ffn`` is
    ``moe`` or ``mlp``; a group's sub-layer kind is its index) and the
    extents the reference stacks it over."""
    from ..models.moe import MoE
    from ..models.transformer import LM, Block

    def walk(m, port, names, stack):
        for n, _ in m.named_parameters(recurse=False):
            yield port + n, tuple(names) + (n,), stack
        for n, child in m.named_children():
            name = n
            if isinstance(m, Block) and n == "ffn":
                name = "moe" if isinstance(child, MoE) else "mlp"
            if isinstance(m, LM) and n == "layers":
                g = _period(child)
                for i, sub in enumerate(child):
                    yield from walk(sub, f"{port}{n}.{i}.",
                                    names + [name, str(i % g)],
                                    stack + (len(child) // g,))
            elif isinstance(child, nn.ModuleList):
                yield from walk_list(child, f"{port}{n}.", names + [name],
                                     stack)
            else:
                yield from walk(child, f"{port}{n}.", names + [name], stack)

    def walk_list(lst, port, names, stack):
        for i, item in enumerate(lst):
            if isinstance(item, nn.ModuleList):
                yield from walk_list(item, f"{port}{i}.", names,
                                     stack + (len(lst),))
            else:
                yield from walk(item, f"{port}{i}.", names,
                                stack + (len(lst),))

    yield from walk(module, "", [], ())


def _serve_spec(spec: Spec) -> Spec:
    return tuple(None if s == "data" else
                 (tuple(a for a in s if a != "data") or None)
                 if isinstance(s, tuple) else s
                 for s in spec)


def param_specs(params: nn.Module | Mapping[str, Any], mesh: Any,
                mode: str = "train") -> dict[str, Spec]:
    """name -> spec of every leaf of a module (through
    :func:`reference_leaves`) or of a ``{name: shape}`` dict (a name is
    its path, ``.``-separated; no stacked dims)."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: 'train' or 'serve'")
    if isinstance(params, nn.Module):
        shapes = dict(params.named_parameters())
        leaves = [(name, path, stack, tuple(shapes[name].shape))
                  for name, path, stack in reference_leaves(params)]
    else:
        leaves = [(name, tuple(name.split(".")), (),
                   tuple(getattr(s, "shape", s)))
                  for name, s in params.items()]
    out = {}
    for name, path, stack, shape in leaves:
        if not shape:
            out[name] = ()
            continue
        spec = spec_for(path, stack + shape, mesh)[len(stack):]
        out[name] = _serve_spec(spec) if mode == "serve" else spec
    return out


def param_shardings(params: nn.Module | Mapping[str, Any], mesh: Any,
                    mode: str = "train") -> dict[str, list]:
    """name -> DTensor placements of every leaf on ``mesh``.

    mode='train': 2-D (FSDP over data × TP over model) — minimum state
    memory; the per-layer weight all-gather amortises over the batch.
    mode='serve': TP-only (no data/FSDP dim) — decode batches are too
    small to amortise weight gathers, so weights replicate across
    `data` and only split over `model`.
    """
    return {n: spec_placements(mesh, s)
            for n, s in param_specs(params, mesh, mode).items()}


def distribute_params(module: nn.Module, mesh: Any, mode: str = "train"
                      ) -> nn.Module:
    """``module`` with every parameter swapped, in place, for a DTensor
    on ``mesh`` placed by :func:`param_shardings`: its local shard is
    this rank's slice of the parameter (no collective runs).  Returns
    ``module``."""
    placements = param_shardings(module, mesh, mode)
    for name, p in list(module.named_parameters()):
        dt = distribute(p.detach(), mesh, placements[name])
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def replicated(tree: Mapping[str, Any], mesh: Any) -> dict[str, list]:
    """name -> fully replicated placements."""
    return {n: spec_placements(mesh, ()) for n in tree}


def batch_specs(batch_shape: Mapping[str, Any], mesh: Any,
                axis: str = "data") -> dict[str, Spec]:
    """Shard dim0 (global batch) of every batch leaf over data (+pod)."""
    sizes = mesh_axes(mesh)
    axes = [a for a in ("pod", axis) if a in sizes]
    out = {}
    for name, leaf in batch_shape.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        extent = int(np.prod([sizes[a] for a in axes]))
        first = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)
        if shape and shape[0] % max(extent, 1) == 0 and extent > 1:
            out[name] = (first,) + (None,) * (len(shape) - 1)
        else:
            out[name] = ()
    return out


def batch_shardings(batch_shape: Mapping[str, Any], mesh: Any,
                    axis: str = "data") -> dict[str, list]:
    """name -> placements of each batch leaf (:func:`batch_specs`)."""
    return {n: spec_placements(mesh, s)
            for n, s in batch_specs(batch_shape, mesh, axis).items()}
