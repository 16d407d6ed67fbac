"""GQA attention: full-sequence forward + cached decode step.

One card has no mesh, so the reference's sharding constraints have no
counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .common import ModelConfig, dense_init, frozen
from .kernels_glue import flash_attention
from .layers import apply_rope, rope_freqs


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


def _qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = cfg.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(dt))
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
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if kv_override is None:
        q, k, v = _qkv(params, x, cfg, positions)
    else:
        dt = cfg.dtype
        (ctx,) = kv_override
        q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", ctx, params.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", ctx, params.wv.to(dt))
        causal = False
    # (B, H, S, hd) layout for the kernel
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          use_pallas=cfg.use_flash)
    out = out.transpose(1, 2)                  # (B, S, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(cfg.dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_layers: int | None = None, *,
               device: torch.device | str) -> KVCache:
    """Stacked-over-layers KV cache (leading dim = layers) on ``device``,
    which the caller always names."""
    L = n_layers or cfg.n_layers
    shape = (L, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device), 0)


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
    b, one, d = x.shape
    s_max = cache_k.shape[2]
    positions = torch.full((1,), length, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    cache_k[:, :, length] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, length] = v[:, 0].to(cache_v.dtype)
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, group, cfg.hd)   # (B, 1, H, hd)
    # the reference's fp32 1/sqrt(hd), as a Python float: a tensor made
    # on the host and copied to the card would synchronise every layer
    scale = float(np.float32(1) / np.sqrt(np.float32(cfg.hd)))
    # the reference multiplies cache-typed operands with fp32
    # accumulation; a matmul in the cache type would round its output,
    # so the operands are widened (a transient copy per layer)
    logits = torch.einsum("bhgk,bhsk->bhgs",
                          qg.to(cache_k.dtype).float(),
                          cache_k.float()) * scale
    mask = torch.arange(s_max, device=x.device) <= length
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsk->bhgk",
                       probs.to(cache_v.dtype).float(), cache_v.float())
    out = out.reshape(b, 1, cfg.n_heads, cfg.hd).to(cfg.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params.wo.to(cfg.dtype))
    return y, cache_k, cache_v
