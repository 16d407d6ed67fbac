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

The port has the flat dispatch only: ``cfg.moe_grouped`` (the
reference's per-data-shard groups) has no effect, on one card and in
the dry-run alike.  The reference's sharding constraint points of the
flat dispatch are kept (``sharding.py``; identities with no mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init, frozen
from .mlp import MLP, init_mlp, mlp_fwd
from .sharding import get_rules


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
    # cfg.moe_grouped has no effect: one card is one group (module docstring)
    if t > DISPATCH_CHUNK_TOKENS and \
            t % DISPATCH_CHUNK_TOKENS == 0 and \
            s % (t // DISPATCH_CHUNK_TOKENS) == 0:
        n_chunks = t // DISPATCH_CHUNK_TOKENS
        xc = x.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
        outs, auxs = zip(*(_moe_dispatch(params, xi, cfg) for xi in xc))
        return (torch.stack(outs).transpose(0, 1).reshape(b, s, d),
                torch.stack(auxs).mean())
    return _moe_dispatch(params, x, cfg)


def route(params: MoE, xt: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (probs (T, E) fp32, gates (T, k), expert ids (T, k)).
    Ties go to the lower expert id, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` does not promise an order)."""
    k = max(1, cfg.top_k)
    probs = torch.softmax(xt.float() @ params.router.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates, ids


def positions(ids: torch.Tensor, n_experts: int, capacity: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert ids (T*k,) in token-major, choice-minor order -> (each
    choice's position as the reference computes it, keep mask)."""
    onehot = F.one_hot(ids, n_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).sum(-1)
    return pos, pos < capacity


def _moe_dispatch(params: MoE, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux): every token dispatched into
    one set of (E, C, d) buffers."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, max(1, cfg.top_k)
    dt = cfg.dtype
    xt = x.reshape(t, d)
    probs, gates, ids = route(params, xt, cfg)
    # load-balancing aux loss (Switch):  e * sum_e fraction_e * prob_e
    me = probs.mean(0)
    ce = F.one_hot(ids, e).float().sum(1).mean(0)
    aux = e * (me * ce).sum()

    capacity = int(max(1, (t * k * cfg.capacity_factor) // e))
    flat_ids = ids.reshape(-1)
    pos, keep = positions(flat_ids, e, capacity)
    safe = torch.where(keep, pos, 0)
    safe = torch.where(safe < 0, safe + capacity, safe)   # counts from the end

    # scatter: a slot still outside [0, C) is dropped (sent to a spare
    # slot C, cut off below), which keeps the index tensors on the card
    slot = torch.where((safe >= 0) & (safe < capacity), safe, capacity)
    upd = torch.where(keep[:, None], xt.to(dt).repeat_interleave(k, 0), 0)
    buf = torch.zeros((e, capacity + 1, d), dtype=dt, device=x.device)
    buf.index_put_((flat_ids, slot), upd, accumulate=True)
    r = get_rules()
    buf = r.constrain(buf[:, :capacity], "expert_act", None, None)

    # the expert FFN: three batched products over the experts
    gate = torch.bmm(buf, params.w_gate.to(dt))
    up = torch.bmm(buf, params.w_up.to(dt))
    act = F.silu(gate.float()).to(dt) * up
    out_buf = torch.bmm(act, params.w_down.to(dt))
    out_buf = r.constrain(out_buf, "expert_act", None, None)

    # combine: the gather clamps into range; dropped choices give zero
    gathered = out_buf[flat_ids, safe.clamp(0, capacity - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = gathered.float() * gates.reshape(-1, 1)
    out = weighted.reshape(t, k, d).sum(1).to(dt)
    if params.shared is not None:
        out = out + mlp_fwd(params.shared, xt, dt)
    return r.constrain(out.reshape(b, s, d), "batch", "seq", "embed_act"), aux
