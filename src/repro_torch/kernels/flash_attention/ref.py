"""Plain PyTorch versions of (G)QA scaled-dot-product attention: the
whole score matrix at once, and a chunked online-softmax form whose
temporaries are O(S·bq) instead of O(S²)."""
from __future__ import annotations

import math

import numpy as np
import torch


def _scale(d: int) -> float:
    """1/sqrt(d) computed in float32, as the reference computes it; a
    Python float, so the card gets no host tensor to copy (and wait on)."""
    return float(np.float32(1) / np.sqrt(np.float32(d)))


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, D); k/v (B, Hkv, S, D) with Hq % Hkv == 0.

    fp32 softmax whatever the input dtype (the kernel's accumulator
    precision); the causal mask is -inf; the output takes q's dtype."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * _scale(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vq)
    return out.to(q.dtype)


def mha_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512
                    ) -> torch.Tensor:
    """Blockwise online-softmax attention over query blocks; each block
    sees the full K/V but only a (bq × S) score tile lives at once.  The
    causal mask is -1e30 and the normaliser is clamped at 1e-30.
    q (B, Hq, S, D), k/v (B, Hkv, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    bq = min(block_q, s)
    while s % bq:
        bq //= 2
    kf, vf = k.float(), v.float()
    # fold the group into the batch for a single einsum pattern
    qf = (q.float() * _scale(d)).reshape(b, hkv, group, s, d)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // bq):
        qb = qf[:, :, :, i * bq:(i + 1) * bq]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf)
        if causal:
            qpos = i * bq + torch.arange(bq, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            logits = logits.masked_fill(~mask, -1e30)
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        outs.append(out / p.sum(-1, keepdim=True).clamp_min(1e-30))
    out = torch.cat(outs, dim=3)                     # (b, hkv, g, s, d)
    return out.reshape(b, hq, s, d).to(q.dtype)
