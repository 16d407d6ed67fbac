"""Decoder-only transformer LM: the dense, MoE and VLM families.

The reference stacks the layers' parameters and scans over them; here
the layers are an ``nn.ModuleList`` walked by a Python loop, in the
reference's order (group by group, sub-layer by sub-layer), so the KV
cache's leading axis means the same layer in both.  MoE interleaving
(llama4's alternate dense/MoE) follows the reference's groups of
``moe_every`` sub-layers, the last of each group MoE.  For serving,
block weights and norm scales are stored in ``cfg.dtype`` once, at init
or load: that is what every per-use cast of the reference computes, at
half the memory in bf16.  A trainer stores them in ``cfg.param_dtype``
as the reference does (``common.training_storage``); every use casts to
``cfg.dtype`` either way.  The embedding and unembedding tables stay in
``cfg.param_dtype`` (fp32).  In training each group of sub-layers is
rematerialised as ``cfg.remat`` asks (``remat.py``), as the reference's
scan body is.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from .attention import (Attention, _qkv, attention_decode, attention_fwd,
                        init_attention, project_out)
from .common import ModelConfig, frozen
from .kernels_glue import flash_attention
from .layers import embed_tokens, init_embedding, rms_norm, unembed
from .mlp import MLP, init_mlp, mlp_fwd
from .moe import MoE, init_moe, moe_fwd
from .remat import remat
from .sharding import get_rules, sp_residual


class Block(nn.Module):
    """One sub-layer: ln1, attention, ln2 and its FFN, an MLP (dense) or
    a mixture of experts (moe)."""

    def __init__(self, ln1: torch.Tensor, attn: Attention,
                 ln2: torch.Tensor, ffn: MLP | MoE):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.attn = attn
        self.ln2 = frozen(ln2)
        self.ffn = ffn


class LM(nn.Module):
    """embed (vocab, d), layers, ln_f (d), unembed (vocab, d) or None
    when the embedding is tied."""

    def __init__(self, embed: torch.Tensor, layers: list[Block],
                 ln_f: torch.Tensor, unembed: torch.Tensor | None = None):
        super().__init__()
        self.embed = frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_f = frozen(ln_f)
        self.unembed = None if unembed is None else frozen(unembed)

    @property
    def out_table(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed


# ----------------------------------------------------------------------
def _group_structure(cfg: ModelConfig) -> tuple[int, list[str]]:
    """(n_groups, sublayer kinds per group).  kinds: 'dense' | 'moe'."""
    if not cfg.is_moe or cfg.moe_every == 0:
        return cfg.n_layers, ["dense"]
    g = cfg.moe_every
    assert cfg.n_layers % g == 0, (cfg.n_layers, g)
    kinds = ["dense"] * (g - 1) + ["moe"]
    return cfg.n_layers // g, kinds


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """Random weights on the generator's device, drawn in fp32."""
    n_groups, kinds = _group_structure(cfg)
    dev, d = generator.device, cfg.d_model

    def ffn(kind):
        if kind == "moe":
            return init_moe(generator, cfg, cfg.dtype)
        return init_mlp(generator, d, cfg.d_ff, cfg.dtype)

    embed = init_embedding(generator, cfg)
    layers = [Block(torch.ones(d, dtype=cfg.dtype, device=dev),
                    init_attention(generator, cfg, cfg.dtype),
                    torch.ones(d, dtype=cfg.dtype, device=dev), ffn(kind))
              for _ in range(n_groups) for kind in kinds]
    out = None if cfg.tie_embeddings else init_embedding(generator, cfg)
    return LM(embed, layers, torch.ones(d, dtype=cfg.dtype, device=dev), out)


# ----------------------------------------------------------------------
def _ffn(sub: Block, x: torch.Tensor, cfg: ModelConfig
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """-> (x + FFN(ln2(x)), the MoE aux loss or None for an MLP)."""
    h = rms_norm(x, sub.ln2.to(cfg.dtype), cfg.norm_eps)
    if isinstance(sub.ffn, MoE):
        y, aux = moe_fwd(sub.ffn, h, cfg)
        return x + y, aux
    return x + mlp_fwd(sub.ffn, h, cfg.dtype), None


def lm_forward(params: LM, cfg: ModelConfig, *,
               tokens: torch.Tensor | None = None,
               embeds: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, vocab) fp32, aux_loss scalar)."""
    if embeds is None:
        x = embed_tokens(params.embed, tokens, cfg.dtype)
    else:
        x = embeds.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    g = len(_group_structure(cfg)[1])
    step = remat(functools.partial(_group_fwd, cfg=cfg), cfg)
    for i in range(0, len(params.layers), g):
        x, a = step(x, positions, list(params.layers[i:i + g]))
        aux = aux + a
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    return unembed(params.out_table, x), aux


def _group_fwd(x: torch.Tensor, positions: torch.Tensor, subs: list[Block],
               cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One group of sub-layers (the reference's scan body) -> (x, the
    group's MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sub in subs:
        h = rms_norm(x, sub.ln1.to(cfg.dtype), cfg.norm_eps)
        x = sp_residual(x + attention_fwd(sub.attn, h, cfg,
                                          positions=positions))
        x, a = _ffn(sub, x, cfg)
        x = sp_residual(x)
        if a is not None:
            aux = aux + a
    return x, aux


# ----------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked KV caches.
def lm_prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt, return (last-position logits, cache).

    The cache holds exactly the prompt K/V (after RoPE; padded with zeros
    to ``max_len`` slots when given) with layout (L, B, Hkv, S, hd).
    """
    x = embed_tokens(params.embed, tokens, cfg.dtype)
    return _prefill_from_embeds(params, cfg, x, max_len)


def lm_prefill_embeds(params: LM, cfg: ModelConfig, embeds: torch.Tensor,
                      max_len: int | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """Prefill from precomputed embeddings (VLM patch+token prompts)."""
    return _prefill_from_embeds(params, cfg, embeds.to(cfg.dtype), max_len)


def _prefill_from_embeds(params: LM, cfg: ModelConfig, x: torch.Tensor,
                         max_len: int | None = None
                         ) -> tuple[torch.Tensor, dict]:
    b, s, _ = x.shape
    max_len = max_len or s
    positions = torch.arange(s, device=x.device)
    shape = (len(params.layers), b, cfg.n_kv_heads, max_len, cfg.hd)
    r = get_rules()
    k_all, v_all = (r.place(torch.zeros(shape, dtype=x.dtype,
                                        device=x.device),
                            "layers", "batch", "kv_heads", "kv_seq", None)
                    for _ in range(2))
    for i, sub in enumerate(params.layers):
        h = rms_norm(x, sub.ln1.to(cfg.dtype), cfg.norm_eps)
        q, k, v = _qkv(sub.attn, h, cfg, positions)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        o = flash_attention(qh, kh, vh, causal=True,
                            use_pallas=cfg.use_flash)
        y = project_out(o.transpose(1, 2), sub.attn.wo.to(cfg.dtype), r)
        x, _ = _ffn(sub, sp_residual(x + y), cfg)
        x = sp_residual(x)
        k_all[i, :, :, :s] = kh
        v_all[i, :, :, :s] = vh
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    logits = unembed(params.out_table, x[:, -1:, :])
    return logits, {"k": k_all, "v": v_all, "length": s}


def lm_decode_step(params: LM, cfg: ModelConfig, token: torch.Tensor,
                   cache: dict) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, vocab), cache).  The cache's K/V
    tensors are updated in place and returned with ``length + 1``."""
    x = embed_tokens(params.embed, token, cfg.dtype)
    length = cache["length"]
    for i, sub in enumerate(params.layers):
        h = rms_norm(x, sub.ln1.to(cfg.dtype), cfg.norm_eps)
        y, _, _ = attention_decode(sub.attn, h, cache["k"][i],
                                   cache["v"][i], length, cfg)
        x, _ = _ffn(sub, x + y, cfg)
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    logits = unembed(params.out_table, x)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}
