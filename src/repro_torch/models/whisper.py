"""Whisper-style encoder–decoder backbone (arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: precomputed frame
embeddings (B, T, d_model) go straight into the encoder.  Encoder layers
are bidirectional attention + GELU MLP; decoder layers add
cross-attention into the encoded audio.  Sinusoidal positions (no
rope), pre-LayerNorm, the embedding tied to the output.

Every attention of the prefill goes through the flash kernel when
``use_flash`` is set: the encoder's (non-causal, T frames), the
decoder's self-attention (causal) and its cross-attention (non-causal,
S tokens against T frames, the kernel sweeping its own T keys).  The
decode step's cross-attention is two products over the cached encoder
K/V, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .attention import (Attention, _project, _qkv, _with_cache,
                        attention_decode, attention_fwd, init_attention,
                        project_heads, project_out)
from .common import ModelConfig, frozen
from .kernels_glue import flash_attention
from .layers import embed_tokens, init_embedding, layer_norm, unembed
from .mlp import MLP, init_mlp, mlp_fwd
from .remat import remat
from .sharding import get_rules, sp_residual


@functools.lru_cache(maxsize=8)
def _sinusoids(length: int, d: int) -> np.ndarray:
    t = np.arange(length)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)
    ang = t * inv[None]
    out = np.zeros((length, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    out.flags.writeable = False
    return out


def _positions(length: int, d: int, like: torch.Tensor,
               rows: slice = slice(None)) -> torch.Tensor:
    """``rows`` of the (length, d) sinusoid table, in ``like``'s dtype on
    its device."""
    table = np.array(_sinusoids(length, d)[rows])
    return torch.from_numpy(table).to(like.device, like.dtype)


class LayerNorm(nn.Module):
    """scale and bias (d), stored in the compute type."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale, self.bias = frozen(scale), frozen(bias)


def _init_ln(d: int, dtype, device) -> LayerNorm:
    return LayerNorm(torch.ones(d, dtype=dtype, device=device),
                     torch.zeros(d, dtype=dtype, device=device))


def _ln(x, p: LayerNorm, eps, dtype):
    return layer_norm(x, p.scale.to(dtype), p.bias.to(dtype), eps)


class EncoderLayer(nn.Module):
    def __init__(self, ln1: LayerNorm, attn: Attention, ln2: LayerNorm,
                 mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecoderLayer(nn.Module):
    def __init__(self, ln1: LayerNorm, attn: Attention, ln_x: LayerNorm,
                 xattn: Attention, ln2: LayerNorm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln_x = ln1, attn, ln_x
        self.xattn, self.ln2, self.mlp = xattn, ln2, mlp


class Whisper(nn.Module):
    """enc_layers, dec_layers, enc_ln_f, dec_ln_f and embed (vocab, d),
    the table of both the tokens and the logits."""

    def __init__(self, enc_layers: list[EncoderLayer],
                 dec_layers: list[DecoderLayer], enc_ln_f: LayerNorm,
                 dec_ln_f: LayerNorm, embed: torch.Tensor):
        super().__init__()
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_ln_f, self.dec_ln_f = enc_ln_f, dec_ln_f
        self.embed = frozen(embed)


def init_whisper(generator: torch.Generator, cfg: ModelConfig) -> Whisper:
    """Random weights on the generator's device, drawn in fp32."""
    d, dt, dev = cfg.d_model, cfg.dtype, generator.device

    def ln():
        return _init_ln(d, dt, dev)

    def mlp():
        return init_mlp(generator, d, cfg.d_ff, dt, gated=False)

    def attn():
        return init_attention(generator, cfg, dt)

    enc = [EncoderLayer(ln(), attn(), ln(), mlp())
           for _ in range(cfg.n_enc_layers or cfg.n_layers)]
    dec = [DecoderLayer(ln(), attn(), ln(), attn(), ln(), mlp())
           for _ in range(cfg.n_layers)]
    return Whisper(enc, dec, ln(), ln(), init_embedding(generator, cfg))


def encode(params: Whisper, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T, d) -> encoded (B, T, d)."""
    dt = cfg.dtype
    x = frames.to(dt)
    x = x + _positions(x.shape[1], x.shape[2], x)[None]

    def body(x, layer):
        h = _ln(x, layer.ln1, cfg.norm_eps, dt)
        x = sp_residual(x + attention_fwd(layer.attn, h, cfg, causal=False))
        h = _ln(x, layer.ln2, cfg.norm_eps, dt)
        return sp_residual(x + mlp_fwd(layer.mlp, h, dt, activation="gelu"))

    step = remat(body, cfg)
    for layer in params.enc_layers:
        x = step(x, layer)
    return _ln(x, params.enc_ln_f, cfg.norm_eps, dt)


def _embed(params: Whisper, tokens: torch.Tensor, dt) -> torch.Tensor:
    x = embed_tokens(params.embed, tokens, dt)
    return x + _positions(x.shape[1], x.shape[2], x)[None]


def whisper_forward(params: Whisper, cfg: ModelConfig, *,
                    frames: torch.Tensor, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    dt = cfg.dtype
    # the encoded audio gathered once for every layer's cross-attention,
    # so each layer's share of its gradient comes back in one placement
    ctx = get_rules().constrain(encode(params, cfg, frames), "batch", "seq",
                                "embed_act")
    x = _embed(params, tokens, dt)

    def body(x, ctx, layer):
        h = _ln(x, layer.ln1, cfg.norm_eps, dt)
        x = sp_residual(x + attention_fwd(layer.attn, h, cfg, causal=True))
        h = _ln(x, layer.ln_x, cfg.norm_eps, dt)
        x = sp_residual(x + attention_fwd(layer.xattn, h, cfg,
                                          kv_override=(ctx,)))
        h = _ln(x, layer.ln2, cfg.norm_eps, dt)
        return sp_residual(x + mlp_fwd(layer.mlp, h, dt, activation="gelu"))

    step = remat(body, cfg)
    for layer in params.dec_layers:
        x = step(x, ctx, layer)
    x = _ln(x, params.dec_ln_f, cfg.norm_eps, dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params.embed, x), aux


# ----------------------------------------------------------------------
def _attend(params: Attention, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, cfg: ModelConfig, *, causal: bool
            ) -> torch.Tensor:
    """q (B, H, S, hd) against k/v (B, Hkv, T, hd) through the kernel, then
    the output projection: (B, S, d)."""
    o = flash_attention(q, k, v, causal=causal, use_pallas=cfg.use_flash)
    return project_out(o.transpose(1, 2), params.wo.to(cfg.dtype),
                       get_rules())


def whisper_prefill(params: Whisper, cfg: ModelConfig, frames: torch.Tensor,
                    tokens: torch.Tensor, max_len: int
                    ) -> tuple[torch.Tensor, dict]:
    """Encode audio + run prompt tokens; build the self-attention K/V
    cache (L, B, Hkv, max_len, hd), zero past the prompt, and the
    cross-attention K/V of the encoded audio (L, B, Hkv, T, hd)."""
    dt = cfg.dtype
    ctx = encode(params, cfg, frames)
    x = _embed(params, tokens, dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache = init_whisper_cache(cfg, b, max_len, frames=ctx.shape[1],
                               device=x.device)
    cache["length"] = s
    for i, layer in enumerate(params.dec_layers):
        # each projection once: into the cache, and the kernel reads those
        h = _ln(x, layer.ln1, cfg.norm_eps, dt)
        q, k, v = (t.transpose(1, 2) for t in _qkv(layer.attn, h, cfg,
                                                   positions))
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        x = x + _attend(layer.attn, q, k, v, cfg, causal=True)
        h = _ln(x, layer.ln_x, cfg.norm_eps, dt)
        q, xk, xv = (t.transpose(1, 2) for t in _project(
            layer.xattn, h, ctx, cfg, get_rules()))
        cache["xk"][i] = xk
        cache["xv"][i] = xv
        x = x + _attend(layer.xattn, q, cache["xk"][i], cache["xv"][i], cfg,
                        causal=False)
        h = _ln(x, layer.ln2, cfg.norm_eps, dt)
        x = x + mlp_fwd(layer.mlp, h, dt, activation="gelu")
    x = _ln(x, params.dec_ln_f, cfg.norm_eps, dt)
    return unembed(params.embed, x[:, -1:, :]), cache


def whisper_decode_step(params: Whisper, cfg: ModelConfig,
                        token: torch.Tensor, cache: dict
                        ) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, vocab), cache with ``length + 1``);
    the self-attention K/V are written in place."""
    dt = cfg.dtype
    length = cache["length"]
    x = embed_tokens(params.embed, token, dt)
    b, _, d = x.shape
    max_len = cache["k"].shape[3]
    if length >= max_len:
        raise ValueError(f"whisper decode: position {length} is past the "
                         f"cache's {max_len} slots")
    x = x + _positions(max_len, d, x, slice(length, length + 1))[None]
    group = cfg.n_heads // cfg.n_kv_heads
    # the reference's fp32 1/sqrt(hd), as a Python float
    scale = float(np.float32(1) / np.sqrt(np.float32(cfg.hd)))
    r = get_rules()
    for i, layer in enumerate(params.dec_layers):
        h = _ln(x, layer.ln1, cfg.norm_eps, dt)
        y, _, _ = attention_decode(layer.attn, h, cache["k"][i],
                                   cache["v"][i], length, cfg)
        x = x + y
        h = _ln(x, layer.ln_x, cfg.norm_eps, dt)
        # cross-attention: full (non-causal) attention over encoder K/V;
        # cache-typed operands, fp32 products, as in the reference
        xk, xv = cache["xk"][i], cache["xv"][i]
        # the heads whole before they are grouped (as attention_decode)
        q = project_heads(h, layer.xattn.wq.to(dt), r,
                          ("batch", None, None, None))
        qg = q.reshape(b, cfg.n_kv_heads, group, cfg.hd)
        logits = _with_cache("bhgk,bhsk->bhgs", qg.to(xk.dtype).float(),
                             xk.float(), r) * scale
        probs = torch.softmax(logits, dim=-1)
        o = _with_cache("bhgs,bhsk->bhgk", probs.to(xv.dtype).float(),
                        xv.float(), r)
        o = o.reshape(b, 1, cfg.n_heads, cfg.hd)
        x = x + project_out(o.to(dt), layer.xattn.wo.to(dt), r)
        h = _ln(x, layer.ln2, cfg.norm_eps, dt)
        x = x + mlp_fwd(layer.mlp, h, dt, activation="gelu")
    x = _ln(x, params.dec_ln_f, cfg.norm_eps, dt)
    return unembed(params.embed, x), dict(cache, length=length + 1)


def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                       frames: int | None = None,
                       device: torch.device | str) -> dict:
    """Zero self- (max_len) and cross- (``frames``; ``max_frames``, else
    1500) K/V of every decoder layer."""
    t = frames or cfg.max_frames or 1500

    rules = get_rules()

    def kv(s):
        return rules.place(
            torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.hd),
                        dtype=cfg.dtype, device=device),
            "layers", "batch", "kv_heads", "kv_seq", None)

    return {"k": kv(max_len), "v": kv(max_len), "xk": kv(t), "xv": kv(t),
            "length": 0}
