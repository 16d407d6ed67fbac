"""Shared layers: norms, rotary embeddings, token embedding, dense."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init
from .sharding import get_rules


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, fraction: float, theta: float,
               positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (…, rot_dim/2) for given positions (any shape)."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, rot/2) -> rotated x.

    Interleaved pairs (x[..., 0::2], x[..., 1::2]) rotate.  Partial
    rotary: only the first ``2*cos.shape[-1]`` dims rotate (chatglm-style
    2-d / half rope), the rest pass through.
    """
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1f = xr[..., 0::2].float()
    x2f = xr[..., 1::2].float()
    # broadcast cos/sin over the head axis: (..., S, 1, rot/2)
    c = cos[..., :, None, :].float()
    s = sin[..., :, None, :].float()
    o1 = x1f * c - x2f * s
    o2 = x2f * c + x1f * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


# ----------------------------------------------------------------------
def init_embedding(generator: torch.Generator, cfg: ModelConfig
                   ) -> torch.Tensor:
    return dense_init(generator, cfg.d_model, (cfg.vocab, cfg.d_model),
                      cfg.param_dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, dtype
                 ) -> torch.Tensor:
    """Gather rows of the table, in ``dtype``.  Gathering before the cast
    gives the reference's cast-then-gather values without a cast copy of
    the whole table per call.  ``F.embedding`` rather than indexing: its
    backward sums a repeated token's gradients in a fixed order, where
    indexing's (an accumulating ``index_put_``) adds them in whatever
    order the CPU threads reach them, so a resumed training run could not
    replay an uninterrupted one bit for bit."""
    r = get_rules()
    # the table's d_model shards are gathered before the lookup (its
    # vocab stays split): a batch split over `data` meets whole rows
    table = r.constrain(table, "vocab", "embed_act")
    out = F.embedding(tokens.long(), table).to(dtype)
    return r.constrain(out, "batch", "seq", "embed_act")


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, vocab) logits, fp32."""
    r = get_rules()
    # the sequence-parallel residual is gathered before the product
    x = r.constrain(x, "batch", "seq", "embed_act")
    # the table pinned, so its gradient comes back in its placements: a
    # tied table's other share (the lookup's) arrives in them, and torch
    # 2.11 cannot add a split share into a partial sum
    logits = torch.einsum("bsd,vd->bsv", x.float(), r.pin(table).float())
    return r.constrain(logits, "batch", "seq", "vocab_act")
