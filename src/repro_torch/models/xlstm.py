"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, true recurrence), interleaved 7:1 as in the
released xLSTM-1.3b recipe (``slstm_every = 8``).

mLSTM maps onto the same chunked linear-recurrence engine as Mamba-2
(q→query, k→key, i_t folded into v, log σ(f̃) as decay); the
normaliser state n_t is carried as one extra value column appended to v
(state columns P+1), so one engine invocation yields both C_t·q and
n_t·q.  Denominator per the paper: max(|nᵀq|, 1).

sLSTM keeps the exponential-gate scalar recurrence with the m-state
stabiliser and a per-head recurrent matrix R — sequential by
construction (a Python loop over time).  Its ``r_gates`` stay fp32, as
the reference keeps and uses them; every other weight is stored in the
compute type.

Under a mesh (the dry-run) both recurrences, and the mLSTM's decode
step, run on each rank's local shards (``sharding.on_shards``): each
sequence and head recurs on its own, where DTensor op by op would cost
host time at every step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import project_heads, split_heads
from .common import ModelConfig, dense_init, frozen
from .layers import rms_norm
from .sharding import get_rules, is_dtensor, on_shards
from .ssd import decode_scan_step, sharded_scan


def _key_scale(p: int, dtype) -> float:
    """sqrt(p) rounded to ``dtype``, as the reference's
    ``jnp.sqrt(jnp.asarray(p, dtype))``; a Python float, so a card gets
    no host tensor to copy."""
    return float(torch.sqrt(torch.tensor(float(p), dtype=dtype)))


# ======================================================================
# mLSTM
class MLSTMBlock(nn.Module):
    """ln (d), wq/wk/wv (d, H, P), w_if (d, 2H), w_o (d, d),
    w_out (d, d), norm (d)."""

    def __init__(self, ln, wq, wk, wv, w_if, w_o, w_out, norm):
        super().__init__()
        (self.ln, self.wq, self.wk, self.wv, self.w_if, self.w_o,
         self.w_out, self.norm) = map(frozen, (ln, wq, wk, wv, w_if, w_o,
                                               w_out, norm))


def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig
                     ) -> MLSTMBlock:
    d, h, dt, dev = cfg.d_model, cfg.n_heads, cfg.dtype, generator.device
    p = d // h
    return MLSTMBlock(
        torch.ones(d, dtype=dt, device=dev),
        *(dense_init(generator, d, (d, h, p), dt) for _ in range(3)),
        dense_init(generator, d, (d, 2 * h), dt),
        dense_init(generator, d, (d, d), dt),
        dense_init(generator, d, (d, d), dt),
        torch.ones(d, dtype=dt, device=dev))


def _mlstm_gates(params: MLSTMBlock, hx, dtype):
    gates = torch.einsum("bsd,dg->bsg", hx, params.w_if.to(dtype))
    h2 = gates.shape[-1] // 2
    i_raw = gates[..., :h2].float()
    f_raw = gates[..., h2:].float()
    # log σ as jax.nn.log_sigmoid defines it (DTensor has no strategy
    # for F.logsigmoid)
    log_f = -F.softplus(-f_raw)                  # decay ≤ 0
    log_i = -F.softplus(-i_raw)                  # = log σ(ĩ) ≤ 0
    return log_i, log_f


def _mlstm_in(params: MLSTMBlock, x, cfg: ModelConfig):
    """-> (hx, q, k / sqrt(P), v, log_i, log_f), q/k/v (B, S, H, P)
    projected over the flattened heads (``attention.project_heads``)."""
    dt = cfg.dtype
    p = cfg.d_model // cfg.n_heads
    r = get_rules()
    # the sequence-parallel residual is gathered before the block
    x = r.constrain(x, "batch", "seq", "embed_act")
    hx = rms_norm(x, params.ln.to(dt), cfg.norm_eps)
    q, k, v = (project_heads(hx, w.to(dt), r, ("batch", None, "heads", None))
               for w in (params.wq, params.wk, params.wv))
    k = k / _key_scale(p, dt)
    log_i, log_f = _mlstm_gates(params, hx, dt)
    return hx, q, k, v, log_i, log_f


def _mlstm_out(params: MLSTMBlock, hx, y_ext, cfg: ModelConfig):
    """Engine output (B, S, H, P+1) -> the block's output (B, S, d)."""
    b, s = hx.shape[:2]
    dt = cfg.dtype
    p = cfg.d_model // cfg.n_heads
    y_num, y_den = y_ext[..., :p], y_ext[..., p:]
    # the heads flattened and pinned, so the backward hands the
    # gradient back in their placements before it unflattens them
    y = get_rules().pin(
        (y_num / y_den.abs().clamp_min(1.0)).to(dt).reshape(b, s, -1))
    og = torch.sigmoid(torch.einsum("bsd,de->bse", hx, params.w_o.to(dt))
                       .float()).to(dt)
    y = rms_norm(y * og, params.norm.to(dt), cfg.norm_eps)
    return torch.einsum("bsd,de->bse", y, params.w_out.to(dt))


def _v_ext(v, log_i):
    """Input gate folded into v, and the normaliser's column i_t."""
    i = torch.exp(log_i)[..., None]
    return torch.cat([v.float() * i, i], dim=-1)


def mlstm_fwd(params: MLSTMBlock, x: torch.Tensor, cfg: ModelConfig, *,
              chunk: int = 64) -> torch.Tensor:
    r = get_rules()
    hx, q, k, v, log_i, log_f = _mlstm_in(params, x, cfg)
    y_ext = sharded_scan(q.float(), k.float(), _v_ext(v, log_i), log_f,
                         chunk=chunk)
    out = _mlstm_out(params, hx, y_ext, cfg)
    return r.constrain(out, "batch", "seq", "embed_act")


class MLSTMCache(NamedTuple):
    state: torch.Tensor     # (B, H, P, P+1) fp32


def init_mlstm_cache(cfg: ModelConfig, batch: int, lead: tuple = (), *,
                     device: torch.device | str) -> MLSTMCache:
    h = cfg.n_heads
    p = cfg.d_model // h
    return MLSTMCache(torch.zeros(lead + (batch, h, p, p + 1),
                                  dtype=torch.float32, device=device))


def mlstm_step(params: MLSTMBlock, x: torch.Tensor, cache: MLSTMCache,
               cfg: ModelConfig) -> tuple[torch.Tensor, MLSTMCache]:
    hx, q, k, v, log_i, log_f = _mlstm_in(params, x, cfg)
    y_ext, new_state = decode_scan_step(
        q[:, 0].float(), k[:, 0].float(), _v_ext(v[:, 0], log_i[:, 0]),
        log_f[:, 0], cache.state)
    return _mlstm_out(params, hx, y_ext[:, None], cfg), MLSTMCache(new_state)


# ======================================================================
# sLSTM
class SLSTMBlock(nn.Module):
    """ln (d), w_gates (d, 4d), r_gates (H, P, 4P) fp32, w_out (d, d),
    norm (d)."""

    def __init__(self, ln, w_gates, r_gates, w_out, norm):
        super().__init__()
        self.ln, self.w_gates, self.r_gates, self.w_out, self.norm = map(
            frozen, (ln, w_gates, r_gates, w_out, norm))


def init_slstm_block(generator: torch.Generator, cfg: ModelConfig
                     ) -> SLSTMBlock:
    d, h, dt, dev = cfg.d_model, cfg.n_heads, cfg.dtype, generator.device
    p = d // h
    return SLSTMBlock(
        torch.ones(d, dtype=dt, device=dev),
        dense_init(generator, d, (d, 4 * d), dt),
        dense_init(generator, p, (h, p, 4 * p), torch.float32),
        dense_init(generator, d, (d, d), dt),
        torch.ones(d, dtype=dt, device=dev))


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, H, P)
    n: torch.Tensor   # (B, H, P)
    m: torch.Tensor   # (B, H, P) stabiliser
    h: torch.Tensor   # (B, H, P) hidden


def init_slstm_cache(cfg: ModelConfig, batch: int, lead: tuple = (), *,
                     device: torch.device | str) -> SLSTMCache:
    hh = cfg.n_heads
    shape = lead + (batch, hh, cfg.d_model // hh)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SLSTMCache(z(), z(), z() - 1e30, z())


def _slstm_cell(r_gates: torch.Tensor, xt, cache: SLSTMCache
                ) -> tuple[torch.Tensor, SLSTMCache]:
    """xt: pre-computed gate inputs (B, H, 4P) fp32; r_gates (H, P, 4P)
    fp32."""
    rec = torch.einsum("bhp,hpq->bhq", cache.h, r_gates)
    zr, ir, fr, orr = torch.chunk(xt + rec, 4, dim=-1)
    z = torch.tanh(zr)
    log_i = ir                                    # exp input gate (log dom)
    log_f = -F.softplus(-fr)                      # log σ, as in the mLSTM
    m_new = torch.maximum(log_f + cache.m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + cache.m - m_new)
    c_new = f_s * cache.c + i_s * z
    n_new = (f_s * cache.n + i_s).clamp_min(1e-6)
    h_new = torch.sigmoid(orr) * (c_new / n_new)
    return h_new, SLSTMCache(c_new, n_new, m_new, h_new)


def _slstm_gates_in(params: SLSTMBlock, x, cfg: ModelConfig):
    """Gate inputs (B, S, H, 4P) fp32, placed once for the whole
    sequence (under a mesh the loop would otherwise reduce each step's
    slice of a partial sum)."""
    r = get_rules()
    x = r.constrain(x, "batch", "seq", "embed_act")     # as the mLSTM's
    hx = rms_norm(x, params.ln.to(cfg.dtype), cfg.norm_eps)
    gates = torch.matmul(hx, r.pin(params.w_gates.to(cfg.dtype)))
    return split_heads(gates, cfg.n_heads, r,
                       ("batch", None, "heads", None)).float()


def _slstm_out(params: SLSTMBlock, hs, cfg: ModelConfig):
    """Hidden states (B, S, H, P) -> the block's output (B, S, d)."""
    b, s = hs.shape[:2]
    y = get_rules().pin(hs.reshape(b, s, -1).to(cfg.dtype))   # as mLSTM's
    y = rms_norm(y, params.norm.to(cfg.dtype), cfg.norm_eps)
    return torch.einsum("bsd,de->bse", y, params.w_out.to(cfg.dtype))


def _slstm_scan(gates_in: torch.Tensor, r_gates: torch.Tensor
                ) -> torch.Tensor:
    """The recurrence over time from the zero state: gate inputs (B, S,
    H, 4P) -> hidden states (B, S, H, P)."""
    b, s, h, p4 = gates_in.shape
    z = gates_in.new_zeros((b, h, p4 // 4))
    cache = SLSTMCache(z, z, z - 1e30, z)
    hs = []
    for t in range(s):
        h_new, cache = _slstm_cell(r_gates, gates_in[:, t], cache)
        hs.append(h_new)
    return torch.stack(hs, dim=1)


def slstm_fwd(params: SLSTMBlock, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    r = get_rules()
    gates_in = _slstm_gates_in(params, x, cfg)
    r_gates = params.r_gates.float()
    if r.mesh is None or not is_dtensor(gates_in):
        hs = _slstm_scan(gates_in, r_gates)
    else:
        # each sequence and head recurs on its own: the loop runs on each
        # rank's shards (op by op under DTensor each step costs host time
        # in sharding propagation)
        from torch.distributed.tensor import Partial, Replicate, Shard
        gp = r.placements(gates_in.shape, "batch", None, "heads", None)
        heads = [Shard(0) if p == Shard(2) else Replicate() for p in gp]
        # a batch shard's gradient of r_gates is its partial sum
        grad = [Partial() if p == Shard(0) else q for p, q in zip(gp, heads)]
        hs = on_shards(_slstm_scan, r.mesh, (gates_in, r_gates),
                       [gp, heads], gp, in_grad_placements=[gp, grad])
    out = _slstm_out(params, hs, cfg)
    return r.constrain(out, "batch", "seq", "embed_act")


def slstm_step(params: SLSTMBlock, x: torch.Tensor, cache: SLSTMCache,
               cfg: ModelConfig) -> tuple[torch.Tensor, SLSTMCache]:
    gt = _slstm_gates_in(params, x, cfg)[:, 0]
    h_new, cache = _slstm_cell(params.r_gates.float(), gt, cache)
    return _slstm_out(params, h_new[:, None], cfg), cache
