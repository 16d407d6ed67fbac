"""GQA attention: full-sequence forward + cached decode step.

The reference's sharding constraint points are kept (``sharding.py``):
under a mesh (the dry-run) each redistributes a DTensor to its logical
axes' placements; with no mesh each returns its input itself.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .common import ModelConfig, dense_init, frozen
from .kernels_glue import flash_attention
from .layers import apply_rope, rope_freqs
from .sharding import get_rules, mesh_axes, on_shards


class Attention(nn.Module):
    """wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d): the reference's
    shapes, so a converted weight needs no transpose."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(frozen, (wq, wk, wv, wo))


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype,
                   d_model: int | None = None) -> Attention:
    """Weights drawn in fp32 and stored in ``dtype``."""
    d = d_model or cfg.d_model
    hd = cfg.hd
    return Attention(
        dense_init(generator, d, (d, cfg.n_heads, hd), dtype),
        dense_init(generator, d, (d, cfg.n_kv_heads, hd), dtype),
        dense_init(generator, d, (d, cfg.n_kv_heads, hd), dtype),
        dense_init(generator, cfg.n_heads * hd, (cfg.n_heads, hd, d), dtype))


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, Hkv, S_max, hd)
    v: torch.Tensor
    length: int          # tokens filled


def _head_axes(r, cfg: ModelConfig, n_heads: int, kind: str) -> tuple:
    """('batch', seq_axis, head_axis, None) with the context-parallel
    fallback when heads don't divide the TP extent (cfg flag)."""
    if cfg.seq_shard_fallback and r.mesh is not None:
        ext = mesh_axes(r.mesh).get("model", 1)
        if ext > 1 and n_heads % ext != 0:
            return ("batch", "seq_sp", None, None)
    return ("batch", "seq", kind, None)


def project_heads(x: torch.Tensor, w: torch.Tensor, r, axes: tuple
                  ) -> torch.Tensor:
    """x (B, S, d) · w (d, H, hd) -> (B, S, H, hd), constrained to the
    logical ``axes``.  The product runs over the flattened head dims and
    is placed before the heads are unflattened: under a mesh DTensor
    cannot unflatten a dim it sharded finer than the heads divide (8 kv
    heads over a 16-way model axis).  The flattened weight is pinned, so
    its gradient comes back in its placements before the backward
    unflattens it."""
    d, h, hd = w.shape
    return split_heads(torch.matmul(x, r.pin(w.reshape(d, h * hd))), h, r,
                       axes)


def split_heads(y: torch.Tensor, n_heads: int, r, axes: tuple
                ) -> torch.Tensor:
    """y (B, S, H·hd) -> (B, S, H, hd), placed by the logical ``axes``
    before the heads are unflattened (see :func:`project_heads`)."""
    b, s, n = y.shape
    shape = (b, s, n_heads, n // n_heads)
    return r.constrain(y, *axes, shape=shape).view(shape)


def project_out(out: torch.Tensor, wo: torch.Tensor, r) -> torch.Tensor:
    """out (B, S, H, hd) · wo (H, hd, d) -> (B, S, d) over the flattened
    heads, both operands pinned (see :func:`project_heads`)."""
    b, s, h, hd = out.shape
    return torch.matmul(r.pin(out.reshape(b, s, h * hd)),
                        r.pin(wo.reshape(h * hd, wo.shape[-1])))


def _project(params: Attention, x: torch.Tensor, ctx: torch.Tensor | None,
             cfg: ModelConfig, r) -> tuple:
    """q from x, k and v from ``ctx`` (x itself when None), each (B, S,
    H, hd); the sequence-parallel residual is gathered first."""
    dt = cfg.dtype
    x = r.constrain(x, "batch", "seq", "embed_act")
    ctx = x if ctx is None else r.constrain(ctx, "batch", "seq", "embed_act")
    kv_axes = _head_axes(r, cfg, cfg.n_kv_heads, "kv_heads")
    return (project_heads(x, params.wq.to(dt), r,
                          _head_axes(r, cfg, cfg.n_heads, "heads")),
            project_heads(ctx, params.wk.to(dt), r, kv_axes),
            project_heads(ctx, params.wv.to(dt), r, kv_axes))


def _qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project(params, x, None, cfg, get_rules())
    if cfg.rope_fraction > 0:
        cos, sin = rope_freqs(cfg.hd, cfg.rope_fraction, cfg.rope_theta,
                              positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_fwd(params: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                  causal: bool = True,
                  positions: torch.Tensor | None = None,
                  kv_override: tuple | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  x: (B, S, d).

    ``kv_override=(ctx,)`` is cross-attention (Whisper's decoder): q from
    x, k and v from ``ctx`` (B, T, d), no rotary, never causal; the
    kernel sweeps the T keys of ``ctx`` whatever S is."""
    r = get_rules()
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if kv_override is None:
        q, k, v = _qkv(params, x, cfg, positions)
    else:
        q, k, v = _project(params, x, kv_override[0], cfg, r)
        causal = False
    # (B, H, S, hd) layout for the kernel
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          use_pallas=cfg.use_flash)
    out = out.transpose(1, 2)                  # (B, S, H, hd)
    out = r.constrain(out, *_head_axes(r, cfg, cfg.n_heads, "heads"))
    y = project_out(out, params.wo.to(cfg.dtype), r)
    return r.constrain(y, "batch", "seq", "embed_act")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_layers: int | None = None, *,
               device: torch.device | str) -> KVCache:
    """Stacked-over-layers KV cache (leading dim = layers) on ``device``,
    which the caller always names."""
    L = n_layers or cfg.n_layers
    shape = (L, batch, cfg.n_kv_heads, max_len, cfg.hd)
    r = get_rules()
    k, v = (r.place(torch.zeros(shape, dtype=cfg.dtype, device=device),
                    "layers", "batch", "kv_heads", "kv_seq", None)
            for _ in range(2))
    return KVCache(k, v, 0)


def _with_cache(eq: str, x: torch.Tensor, cache: torch.Tensor, r
                ) -> torch.Tensor:
    """``einsum(eq, x, cache)`` of x (B, Hkv, G, ·) and a cache (B, Hkv,
    S, hd) over their batch and kv-head dims, run on each rank's shards
    under a mesh: DTensor lowers it by flattening those two dims, which
    torch 2.11 refuses when both are sharded.  The cache's placements
    lead; x follows it along the batch and the kv heads.  A cache split
    along S (split-K decode) leaves the scores split along their last
    dim, and makes the product with the probabilities (x's last dim, S)
    a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if r.mesh is None or not isinstance(cache, DTensor):
        return torch.einsum(eq, x, cache)
    contract_seq = eq.split(",")[0][-1] == "s"
    x_in, out = [], []
    for p in cache.placements:
        if isinstance(p, Shard) and p.dim == 2:
            x_in.append(Shard(3) if contract_seq else Replicate())
            out.append(Partial() if contract_seq else Shard(3))
        else:
            x_in.append(p)
            out.append(p)
    return on_shards(functools.partial(torch.einsum, eq), r.mesh, (x, cache),
                     [x_in, list(cache.placements)], out)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, length: int, r
                ) -> None:
    """``cache[:, :, length] = new`` (cache (B, Hkv, S, hd), new (B, Hkv,
    hd)) in place.  Under a mesh that splits S (split-K decode) only the
    rank whose shard holds the slot writes it, on its local shard:
    DTensor would index the slot on a gathered copy, and the cache would
    keep its old slot."""
    from torch.distributed.tensor import Replicate, Shard
    split = [i for i, p in enumerate(getattr(cache, "placements", ()))
             if isinstance(p, Shard) and p.dim == 2]
    if r.mesh is None or not split:
        cache[:, :, length] = new
        return
    # the slot's rank along each mesh dim that splits S, major to minor
    # (DTensor's order), and its index in that rank's shard
    owner, at, size = [], length, cache.shape[2]
    for i in split:
        per = -(-size // r.mesh.size(i))
        owner.append(at // per)
        at, size = at % per, per
    mine = [r.mesh.get_coordinate()[i] for i in split] == owner

    def write(local, new):
        if mine:
            local[:, :, at] = new
        return local

    new_in = [Replicate() if i in split else p
              for i, p in enumerate(cache.placements)]
    on_shards(write, r.mesh, (cache, new), [list(cache.placements), new_in],
              list(cache.placements))


def attention_decode(params: Attention, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: int, cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B, 1, d); cache_k/v: (B, Hkv, S_max, hd).

    Returns (y, cache_k, cache_v).  The new K/V are written into slot
    ``length`` of the caches IN PLACE (the reference returns updated
    copies); attention runs over the first ``length+1`` slots via
    masking.  A ``length`` past the cache raises instead of being
    clamped as the reference's dynamic_update_slice would.
    """
    r = get_rules()
    b, one, d = x.shape
    s_max = cache_k.shape[2]
    cache_k = r.constrain(cache_k, "batch", "kv_heads", "kv_seq", None)
    cache_v = r.constrain(cache_v, "batch", "kv_heads", "kv_seq", None)
    positions = torch.full((1,), length, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    _write_slot(cache_k, k[:, 0].to(cache_k.dtype), length, r)
    _write_slot(cache_v, v[:, 0].to(cache_v.dtype), length, r)
    group = cfg.n_heads // cfg.n_kv_heads
    # the heads whole before they are grouped: DTensor cannot regroup a
    # head dim whose shards the kv heads do not divide
    q = r.constrain(q, "batch", None, None, None)
    qg = q.reshape(b, cfg.n_kv_heads, group, cfg.hd)   # (B, 1, H, hd)
    # the reference's fp32 1/sqrt(hd), as a Python float: a tensor made
    # on the host and copied to the card would synchronise every layer
    scale = float(np.float32(1) / np.sqrt(np.float32(cfg.hd)))
    # the reference multiplies cache-typed operands with fp32
    # accumulation; a matmul in the cache type would round its output,
    # so the operands are widened (a transient copy per layer)
    logits = _with_cache("bhgk,bhsk->bhgs", qg.to(cache_k.dtype).float(),
                         cache_k.float(), r) * scale
    mask = torch.arange(s_max, device=x.device) <= length
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = _with_cache("bhgs,bhsk->bhgk", probs.to(cache_v.dtype).float(),
                      cache_v.float(), r)
    out = out.reshape(b, 1, cfg.n_heads, cfg.hd).to(cfg.dtype)
    y = project_out(out, params.wo.to(cfg.dtype), r)
    return r.constrain(y, "batch", None, "embed_act"), cache_k, cache_v
