"""Mamba-2 block (SSD) — used inside the Zamba2 hybrid.

Structure per block (Mamba-2 paper, arXiv:2405.21060):
  in_proj -> [z | x | B | C | dt] ; causal conv1d on [x|B|C] ; SiLU;
  SSD over heads (state N, head dim P); +D·x skip; RMSNorm; gate by
  SiLU(z); out_proj.

Group count G=1 (B/C shared across heads).  Decode keeps a (conv
window, SSD state) cache per layer.  Weights cast to the compute type at
every use in the reference are stored in it; ``A_log``, ``dt_bias`` and
``D`` stay fp32, as the reference keeps and uses them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init, frozen
from .layers import rms_norm
from .sharding import get_rules
from .ssd import decode_scan_step, sharded_scan


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_heads or max(1, d_inner // 64)
    p = d_inner // n_heads
    n = cfg.ssm_state
    return d_inner, n_heads, p, n


class MambaBlock(nn.Module):
    """ln (d), w_in (d, 2·d_inner + 2N + H), conv_w (W, conv_dim),
    conv_b (conv_dim), A_log/dt_bias/D (H) fp32, norm (d_inner),
    w_out (d_inner, d)."""

    def __init__(self, ln, w_in, conv_w, conv_b, A_log, dt_bias, D, norm,
                 w_out):
        super().__init__()
        (self.ln, self.w_in, self.conv_w, self.conv_b, self.A_log,
         self.dt_bias, self.D, self.norm, self.w_out) = map(
            frozen, (ln, w_in, conv_w, conv_b, A_log, dt_bias, D, norm,
                     w_out))


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig
                     ) -> MambaBlock:
    d, dt, dev = cfg.d_model, cfg.dtype, generator.device
    d_inner, h, p, n = _dims(cfg)
    conv_dim = d_inner + 2 * n           # x, B, C all convolved (G=1)
    lin = torch.linspace(1e-3, 0.1, h, dtype=torch.float32, device=dev)
    return MambaBlock(
        torch.ones(d, dtype=dt, device=dev),
        dense_init(generator, d, (d, 2 * d_inner + 2 * n + h), dt),
        dense_init(generator, cfg.conv_width, (cfg.conv_width, conv_dim),
                   dt),
        torch.zeros(conv_dim, dtype=dt, device=dev),
        torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                 device=dev)),
        torch.log(torch.expm1(lin)),     # softplus⁻¹ init
        torch.ones(h, dtype=torch.float32, device=dev),
        torch.ones(d_inner, dtype=dt, device=dev),
        dense_init(generator, d_inner, (d_inner, d), dt))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along seq.  x (B, S, C), w (W, C)."""
    width = w.shape[0]
    if prev is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = prev.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return out + b[None, None, :]


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, W-1, conv_dim) rolling window
    ssd: torch.Tensor      # (B, H, N, P) state, fp32


def _project(params: MambaBlock, x: torch.Tensor, cfg: ModelConfig):
    """ln -> in_proj -> (z, [x|B|C], dt_raw)."""
    d_inner, h, _, n = _dims(cfg)
    # the sequence-parallel residual is gathered before the block
    x = get_rules().constrain(x, "batch", "seq", "embed_act")
    hx = rms_norm(x, params.ln.to(cfg.dtype), cfg.norm_eps)
    proj = torch.einsum("bsd,dk->bsk", hx, params.w_in.to(cfg.dtype))
    z, xs, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * n, h],
                                    dim=-1)
    return z, torch.cat([xs, bc], dim=-1), dt_raw


def _output(params: MambaBlock, y: torch.Tensor, z: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """SSD output (..., d_inner) fp32 -> RMSNorm, gate by SiLU(z),
    out_proj."""
    dt_ = cfg.dtype
    y = rms_norm(y.to(dt_), params.norm.to(dt_), cfg.norm_eps)
    y = y * F.silu(z.float()).to(dt_)
    return torch.einsum("bsk,kd->bsd", y, params.w_out.to(dt_))


def mamba_fwd(params: MambaBlock, x: torch.Tensor, cfg: ModelConfig, *,
              chunk: int = 64) -> torch.Tensor:
    """(B, S, d) -> (B, S, d), full-sequence (train / prefill)."""
    b, s, _ = x.shape
    d_inner, h, p, n = _dims(cfg)
    dt_ = cfg.dtype
    z, conv_in, dt_raw = _project(params, x, cfg)
    conv_out = _causal_conv(conv_in, params.conv_w.to(dt_),
                            params.conv_b.to(dt_))
    conv_out = F.silu(conv_out.float()).to(dt_)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + params.dt_bias[None, None, :])  # (B,S,H)
    log_decay = -torch.exp(params.A_log)[None, None, :] * dt

    xh = xs.reshape(b, s, h, p)
    xdt = xh.float() * dt[..., None]
    kq_b = bmat[:, :, None, :].expand(b, s, h, n)
    kq_c = cmat[:, :, None, :].expand(b, s, h, n)
    r = get_rules()
    xdt = r.constrain(xdt, "batch", None, "heads", None)
    y = sharded_scan(kq_c, kq_b, xdt, log_decay, chunk=chunk)
    y = y + params.D[None, None, :, None] * xh.float()
    out = _output(params, y.reshape(b, s, d_inner), z, cfg)
    return r.constrain(out, "batch", "seq", "embed_act")


def init_mamba_cache(cfg: ModelConfig, batch: int, lead: tuple = (), *,
                     device: torch.device | str) -> MambaCache:
    """Zero caches of ``batch`` rows, stacked over the ``lead`` dims."""
    d_inner, h, p, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return MambaCache(
        conv=torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim),
                         dtype=cfg.dtype, device=device),
        ssd=torch.zeros(lead + (batch, h, n, p), dtype=torch.float32,
                        device=device))


def mamba_step(params: MambaBlock, x: torch.Tensor, cache: MambaCache,
               cfg: ModelConfig) -> tuple[torch.Tensor, MambaCache]:
    """Single-token decode.  x (B, 1, d) -> ((B, 1, d), new cache)."""
    b = x.shape[0]
    d_inner, h, p, n = _dims(cfg)
    dt_ = cfg.dtype
    z, conv_in, dt_raw = _project(params, x, cfg)       # (B, 1, conv_dim)
    window = torch.cat([cache.conv.to(dt_), conv_in], dim=1)
    conv_out = (window * params.conv_w.to(dt_)[None]).sum(1, keepdim=True) \
        + params.conv_b.to(dt_)[None, None, :]
    conv_out = F.silu(conv_out.float()).to(dt_)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt_raw[:, 0].float() + params.dt_bias[None, :])  # (B, H)
    log_decay = -torch.exp(params.A_log)[None, :] * dt
    xh = xs[:, 0].reshape(b, h, p)
    xdt = xh.float() * dt[..., None]
    kb = bmat[:, 0, None, :].expand(b, h, n)
    kc = cmat[:, 0, None, :].expand(b, h, n)
    y, ssd_new = decode_scan_step(kc, kb, xdt, log_decay, cache.ssd)
    y = y + params.D[None, :, None] * xh.float()
    out = _output(params, y.reshape(b, 1, d_inner), z, cfg)
    return out, MambaCache(conv=window[:, 1:].to(cfg.dtype), ssd=ssd_new)
