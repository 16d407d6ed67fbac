"""Mixture-of-Experts FFN with capacity-based token dispatch.

The reference's dispatch, step for step: top-k routing on the fp32
softmax -> each (token, choice)'s position within its expert from a
cumulative sum over the one-hot choices, token-major and choice-minor
-> a scatter into (E, C, d) buffers -> the expert FFN as three batched
products -> a gather of each choice's result, weighted by its gate.

Its semantics are kept exactly, including where they hurt:

- the position is ``sum_e(cumsum(onehot) * onehot - 1)``, which is the
  choice's count within its expert minus E, not minus 1;
- a negative position counts from the end of the buffer once (JAX's
  index normalisation); the scatter drops a position still outside
  ``[0, C)`` (``mode="drop"``) and the gather clamps it into range, so a
  choice whose slot was dropped reads another slot of its expert;
- ``keep = pos < C``: only choices past the capacity contribute zero.

Both of the reference's dispatches: the flat one (every token into one
set of buffers) and, with ``cfg.moe_grouped``, the grouped one (GShard's:
the tokens split into g groups, one per data-parallel shard, g =
pod × data of the rules' mesh and 1 with no mesh, halved while it does
not divide the token count; each group with its own positions and its
own capacity ``(T/g · k · capacity_factor) // E``, the quirks above
within each group; the aux loss over all tokens).  One body computes
both, over a leading group dim.  The reference's constraint points are
kept (``sharding.py``; identities with no mesh).

Under a mesh (the dry-run) DTensor has no strategy for the scatter (an
accumulating ``index_put_``) nor for the gather, so both run on local
shards through ``local_map``.  The grouped scatter and gather are
group-local: each rank runs them on its own groups, and the only
traffic left is the ZeRO-3 gather of the expert weights and the
model-axis slice of each group buffer.  The flat scatter is lowered as
XLA lowers the reference's: each rank scatters its own tokens into a
whole buffer, a partial sum over the data-parallel axes that the
``expert_act`` constraint reduces; the flat gather reads the whole
output buffer (gathered over the expert axis) at each rank's tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init, frozen
from .mlp import MLP, init_mlp, mlp_fwd
from .sharding import get_rules, is_dtensor, mesh_axes, on_shards


class MoE(nn.Module):
    """router (d, E) fp32, w_gate/w_up (E, d, f), w_down (E, f, d) and an
    optional shared expert (an MLP of width ``n_shared_experts * f``)."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 shared: MLP | None = None):
        super().__init__()
        self.router = frozen(router)
        self.w_gate, self.w_up, self.w_down = map(frozen,
                                                  (w_gate, w_up, w_down))
        self.shared = shared


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype) -> MoE:
    """Expert weights drawn in fp32 and stored in ``dtype``; the router
    stays fp32, as the reference keeps it."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    router = dense_init(generator, d, (d, e), torch.float32)
    w_gate = dense_init(generator, d, (e, d, ff), dtype)
    w_up = dense_init(generator, d, (e, d, ff), dtype)
    w_down = dense_init(generator, ff, (e, ff, d), dtype)
    shared = (init_mlp(generator, d, cfg.n_shared_experts * ff, dtype)
              if cfg.n_shared_experts else None)
    return MoE(router, w_gate, w_up, w_down, shared)


#: token budget per dispatch — longer inputs are processed in sequence
#: chunks so the one-hot position cumsum and the (E, C, d) buffers stay
#: bounded
DISPATCH_CHUNK_TOKENS = 65_536


def moe_fwd(params: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    # the sequence-parallel residual is gathered before the block
    x = get_rules().constrain(x, "batch", "seq", "embed_act")
    b, s, d = x.shape
    t = b * s
    fn = _moe_dispatch_grouped if cfg.moe_grouped else _moe_dispatch
    if t > DISPATCH_CHUNK_TOKENS and \
            t % DISPATCH_CHUNK_TOKENS == 0 and \
            s % (t // DISPATCH_CHUNK_TOKENS) == 0:
        n_chunks = t // DISPATCH_CHUNK_TOKENS
        xc = x.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
        outs, auxs = zip(*(fn(params, xi, cfg) for xi in xc))
        # pinned: the backward places the gradient before it splits S
        return (get_rules().pin(
            torch.stack(outs).transpose(0, 1).reshape(b, s, d)),
            torch.stack(auxs).mean())
    return fn(params, x, cfg)


def _dp_extent(r) -> int:
    """The data-parallel extent of the rules' mesh, pod × data: the
    grouped dispatch's group count.  1 with no mesh."""
    if r.mesh is None:
        return 1
    sizes = mesh_axes(r.mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def route(params: MoE, xt: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (..., T, d) -> (probs (..., T, E) fp32, gates (..., T, k),
    expert ids (..., T, k)).  Ties go to the lower expert id, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` does not promise an
    order)."""
    k = max(1, cfg.top_k)
    probs = torch.softmax(xt.float() @ params.router.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates, ids


def positions(ids: torch.Tensor, n_experts: int, capacity: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert ids (..., T*k) in token-major, choice-minor order -> (each
    choice's position within its expert and group as the reference
    computes it, keep mask)."""
    onehot = F.one_hot(ids, n_experts)
    pos = (torch.cumsum(onehot, dim=-2) * onehot - 1).sum(-1)
    return pos, pos < capacity


def _group_index(ids: torch.Tensor) -> tuple:
    """The leading index of a scatter or gather into per-group buffers:
    ``(arange(g)[:, None],)`` for ids (g, T*k), none for flat ids."""
    if ids.ndim == 1:
        return ()
    return (torch.arange(ids.shape[0], device=ids.device)[:, None],)


def _scatter(xt: torch.Tensor, ids: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, n_experts: int, capacity: int, dtype
             ) -> torch.Tensor:
    """Each kept choice's token into its expert's slot: xt (..., T, d)
    -> buffers (..., E, C, d).  A slot outside [0, C) is dropped (sent
    to a spare slot C, cut off), which keeps the index tensors on the
    card."""
    k = ids.shape[-1] // xt.shape[-2]
    d = xt.shape[-1]
    upd = torch.where(keep[..., None],
                      xt.to(dtype).repeat_interleave(k, -2), 0)
    buf = torch.zeros(ids.shape[:-1] + (n_experts, capacity + 1, d),
                      dtype=dtype, device=xt.device)
    buf.index_put_(_group_index(ids) + (ids, slot), upd, accumulate=True)
    return buf[..., :capacity, :]


def _gather(out_buf: torch.Tensor, ids: torch.Tensor, safe: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """Each choice's row of its expert's output: the position clamped
    into range, a dropped choice zero -> (..., T*k, d)."""
    capacity = out_buf.shape[-2]
    got = out_buf[_group_index(ids) + (ids, safe.clamp(0, capacity - 1))]
    return torch.where(keep[..., None], got, 0)


def _dispatch(params: MoE, xt: torch.Tensor, cfg: ModelConfig,
              grouped: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """xt (T, d) or (g, T/g, d) -> (out of the same shape, aux)."""
    r = get_rules()
    e, k = cfg.n_experts, max(1, cfg.top_k)
    dt = cfg.dtype
    tg = xt.shape[-2]
    probs, gates, ids = route(params, xt, cfg)
    # load-balancing aux loss (Switch) over all tokens:
    # e * sum_e fraction_e * prob_e
    tokens = tuple(range(probs.ndim - 1))
    me = probs.mean(tokens)
    ce = F.one_hot(ids, e).float().sum(-2).mean(tokens)
    aux = e * (me * ce).sum()

    capacity = int(max(1, (tg * k * cfg.capacity_factor) // e))
    flat_ids = ids.reshape(ids.shape[:-2] + (-1,))
    # a position counts the choices before it in its group: the group's
    # choices whole on each rank (DTensor sums a split dim per shard)
    flat_ids = r.constrain(flat_ids, *(("batch",) if grouped else ()), None)
    pos, keep = positions(flat_ids, e, capacity)
    safe = torch.where(keep, pos, 0)
    safe = torch.where(safe < 0, safe + capacity, safe)   # counts from the end
    slot = torch.where((safe >= 0) & (safe < capacity), safe, capacity)

    def scatter(xt, flat_ids, slot, keep):
        return _scatter(xt, flat_ids, slot, keep, e, capacity, dt)

    buf_axes = ("batch",) if grouped else ("expert_act",)
    # under a mesh: the token-side operands' placements, by their dim 0
    tok = ([r.placements(a.shape, "batch") for a in (xt, flat_ids, slot,
                                                      keep)]
           if is_dtensor(xt) and r.mesh is not None else None)
    if tok is None:
        buf = scatter(xt, flat_ids, slot, keep)
    elif grouped:
        # group-local: each rank fills its own groups' buffers
        buf = on_shards(scatter, r.mesh, (xt, flat_ids, slot, keep), tok,
                        tok[0])
    else:
        # each rank's tokens into a whole buffer: a partial sum over the
        # axes the tokens are split on
        buf = on_shards(scatter, r.mesh, (xt, flat_ids, slot, keep), tok,
                        _partial_where_sharded(tok[0]))
    buf = r.constrain(buf, *buf_axes, None, None, None)

    # the expert FFN: three products batched over the experts (and groups)
    w_gate, w_up, w_down = (params.w_gate.to(dt), params.w_up.to(dt),
                            params.w_down.to(dt))
    h = buf
    if grouped:
        # ZeRO-3 gather: each layer's expert weights whole over the
        # data axis (the experts stay split over model), so the products
        # contract locally instead of all-reducing the (g, E, C, f)
        # partials
        w_gate, w_up, w_down = (r.constrain(w, "expert", None, None)
                                for w in (w_gate, w_up, w_down))
        # the groups folded into the capacity dim: (E, g·C, d)
        g = buf.shape[0]
        h = buf.transpose(0, 1).contiguous().view(e, g * capacity, -1)
    gate = torch.bmm(h, w_gate)
    up = torch.bmm(h, w_up)
    act = F.silu(gate.float()).to(dt) * up
    out_buf = torch.bmm(act, w_down)
    if grouped:
        out_buf = out_buf.view(e, g, capacity, -1).transpose(0, 1)
    out_buf = r.constrain(out_buf, *buf_axes, None, None, None)

    # combine: gather each choice's result, weight it by its gate, sum
    args = (out_buf, flat_ids, safe, keep)
    if tok is None:
        gathered = _gather(*args)
    elif grouped:
        gathered = on_shards(_gather, r.mesh, args, tok, tok[0])
    else:
        # the whole output buffer read at each rank's tokens; its
        # gradient is each rank's partial sum
        from torch.distributed.tensor import Replicate
        gathered = on_shards(_gather, r.mesh, args,
                             [[Replicate()] * r.mesh.ndim] + tok[1:], tok[1],
                             in_grad_placements=[
                                 _partial_where_sharded(tok[1])] + tok[1:])
    weighted = gathered.float() * gates.reshape(flat_ids.shape + (1,))
    out = weighted.reshape(gates.shape + (-1,)).sum(-2).to(dt)
    if params.shared is not None:
        out = out + mlp_fwd(params.shared, xt, dt)
    return out, aux


def _partial_where_sharded(placements: list) -> list:
    """A partial sum on each mesh dim ``placements`` shard, else
    replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in placements]


def _moe_dispatch(params: MoE, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux): every token dispatched into
    one set of (E, C, d) buffers."""
    b, s, d = x.shape
    out, aux = _dispatch(params, x.reshape(b * s, d), cfg, grouped=False)
    return get_rules().constrain(out.reshape(b, s, d), "batch", "seq",
                                 "embed_act"), aux


def _moe_dispatch_grouped(params: MoE, x: torch.Tensor, cfg: ModelConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux): the tokens in g groups (one
    per data-parallel shard), each dispatched into its own (E, C, d)
    buffers with its own capacity."""
    r = get_rules()
    b, s, d = x.shape
    t = b * s
    g = _dp_extent(r)
    while t % g:
        g //= 2
    xt = r.constrain(x.reshape(g, t // g, d), "batch", None, None)
    out, aux = _dispatch(params, xt, cfg, grouped=True)
    return r.constrain(out.reshape(b, s, d), "batch", "seq",
                       "embed_act"), aux
