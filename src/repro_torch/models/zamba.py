"""Zamba2-style hybrid: a Mamba-2 backbone with a *shared* attention+MLP
block applied periodically (arXiv:2411.15242).  The shared block's
weights are reused at every application (Zamba's parameter-sharing
trick); each application keeps its own KV cache.

Layer layout for n_layers = G·k + r with ``attn_every = k``:
  G groups of [k mamba layers → shared transformer block]
  followed by r trailing mamba layers.

The cache keeps the reference's layout (``mamba``: a ``MambaCache`` of
(G, k, B, ...) tensors, ``attn_k``/``attn_v`` (G, B, Hkv, S, hd),
``tail``: (r, B, ...)), and decode writes it in place.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import (Attention, attention_decode, attention_fwd,
                        init_attention)
from .common import ModelConfig, frozen
from .layers import embed_tokens, init_embedding, rms_norm, unembed
from .mamba2 import (MambaBlock, MambaCache, init_mamba_block,
                     init_mamba_cache, mamba_fwd, mamba_step)
from .mlp import MLP, init_mlp, mlp_fwd
from .remat import remat
from .sharding import get_rules, sp_residual


def _layout(cfg: ModelConfig) -> tuple[int, int, int]:
    k = cfg.attn_every or cfg.n_layers
    g = cfg.n_layers // k
    r = cfg.n_layers - g * k
    return g, k, r


class Zamba(nn.Module):
    """embed, groups (G lists of k Mamba blocks), the shared block
    (shared_ln1, shared_attn, shared_ln2, shared_mlp), tail (r Mamba
    blocks), ln_f, and unembed (None when tied)."""

    def __init__(self, embed, groups: list[list[MambaBlock]], shared_ln1,
                 shared_attn: Attention, shared_ln2, shared_mlp: MLP, ln_f,
                 tail: list[MambaBlock], unembed=None):
        super().__init__()
        self.embed = frozen(embed)
        self.groups = nn.ModuleList(nn.ModuleList(g) for g in groups)
        self.shared_ln1 = frozen(shared_ln1)
        self.shared_attn = shared_attn
        self.shared_ln2 = frozen(shared_ln2)
        self.shared_mlp = shared_mlp
        self.ln_f = frozen(ln_f)
        self.tail = nn.ModuleList(tail)
        self.unembed = None if unembed is None else frozen(unembed)

    @property
    def out_table(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed


def init_zamba(generator: torch.Generator, cfg: ModelConfig) -> Zamba:
    """Random weights on the generator's device, drawn in fp32."""
    g, k, r = _layout(cfg)
    d, dt, dev = cfg.d_model, cfg.dtype, generator.device
    groups = [[init_mamba_block(generator, cfg) for _ in range(k)]
              for _ in range(g)]
    return Zamba(
        init_embedding(generator, cfg), groups,
        torch.ones(d, dtype=dt, device=dev),
        init_attention(generator, cfg, dt),
        torch.ones(d, dtype=dt, device=dev),
        init_mlp(generator, d, cfg.d_ff, dt),
        torch.ones(d, dtype=dt, device=dev),
        [init_mamba_block(generator, cfg) for _ in range(r)],
        None if cfg.tie_embeddings else init_embedding(generator, cfg))


def _shared_block(params: Zamba, x, cfg: ModelConfig, positions):
    h = rms_norm(x, params.shared_ln1.to(cfg.dtype), cfg.norm_eps)
    x = x + attention_fwd(params.shared_attn, h, cfg, positions=positions)
    h = rms_norm(x, params.shared_ln2.to(cfg.dtype), cfg.norm_eps)
    return x + mlp_fwd(params.shared_mlp, h, cfg.dtype)


def zamba_forward(params: Zamba, cfg: ModelConfig, *,
                  tokens: torch.Tensor | None = None,
                  embeds: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    x = (embed_tokens(params.embed, tokens, cfg.dtype)
         if embeds is None else embeds.to(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)

    def group_body(x, group):
        for layer in group:
            x = sp_residual(x + mamba_fwd(layer, x, cfg))
        return sp_residual(_shared_block(params, x, cfg, positions))

    step = remat(group_body, cfg)       # the tail is not, as in the reference
    for group in params.groups:
        x = step(x, group)
    for layer in params.tail:
        x = sp_residual(x + mamba_fwd(layer, x, cfg))
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params.out_table, x), aux


# ----------------------------------------------------------------------
def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     device: torch.device | str) -> dict:
    g, k, r = _layout(cfg)
    rules = get_rules()

    def kv():
        return rules.place(
            torch.zeros((g, batch, cfg.n_kv_heads, max_len, cfg.hd),
                        dtype=cfg.dtype, device=device),
            None, "batch", "kv_heads", "kv_seq", None)

    def pin(lead):
        # conv (B, W-1, conv) and ssd (B, H, N, P) leaves, stacked `lead`
        one = init_mamba_cache(cfg, batch, lead, device=device)
        pad = [None] * len(lead)
        return MambaCache(
            conv=rules.place(one.conv, *pad, "batch", None, "ffn_act"),
            ssd=rules.place(one.ssd, *pad, "batch", "heads", None, None))

    cache = {"mamba": pin((g, k)), "attn_k": kv(), "attn_v": kv(),
             "length": 0}
    if r:
        cache["tail"] = pin((r,))
    return cache


def _mamba_steps(layers, x, stack: MambaCache, cfg: ModelConfig, lead=()):
    """Run the Mamba layers' decode steps, writing each layer's new state
    into ``stack[lead + (i,)]`` in place."""
    for i, layer in enumerate(layers):
        at = lead + (i,)
        y, new = mamba_step(layer, x, MambaCache(stack.conv[at],
                                                 stack.ssd[at]), cfg)
        stack.conv[at] = new.conv
        stack.ssd[at] = new.ssd
        x = x + y
    return x


def zamba_decode_step(params: Zamba, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, vocab), cache with ``length + 1``);
    the cache's tensors are updated in place."""
    x = embed_tokens(params.embed, token, cfg.dtype)
    length = cache["length"]
    for gi, group in enumerate(params.groups):
        x = _mamba_steps(group, x, cache["mamba"], cfg, (gi,))
        h = rms_norm(x, params.shared_ln1.to(cfg.dtype), cfg.norm_eps)
        y, _, _ = attention_decode(params.shared_attn, h,
                                   cache["attn_k"][gi], cache["attn_v"][gi],
                                   length, cfg)
        x = x + y
        h = rms_norm(x, params.shared_ln2.to(cfg.dtype), cfg.norm_eps)
        x = x + mlp_fwd(params.shared_mlp, h, cfg.dtype)
    if "tail" in cache:
        x = _mamba_steps(params.tail, x, cache["tail"], cfg)
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    return unembed(params.out_table, x), dict(cache, length=length + 1)
