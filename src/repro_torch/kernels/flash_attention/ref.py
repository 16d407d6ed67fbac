"""Plain PyTorch versions of (G)QA scaled-dot-product attention: the
whole score matrix at once, a chunked online-softmax form whose
temporaries are O(S·bq) instead of O(S²), and the bf16 kernel's own
tiled arithmetic (tests and the card check only)."""
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
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D) with Hq % Hkv == 0 (Sk = Sq
    when causal).

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


#: key rows per pass of the bf16 kernel's sweep (csrc/flash_attention.cu BK)
BLOCK_K = 64


def _split_p(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 P as the bf16 kernel feeds it to the PV product: ``hi =
    bf16(p)`` and ``lo = bf16(p - hi)``, each widened back to fp32."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def mha_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """The bf16 flash kernel's arithmetic, step for step: an online
    softmax over ``BLOCK_K``-key tiles; products of the bf16 operands
    summed in fp32; the fp32 scale applied to the scores (not to q);
    masked scores -1e30; P split into ``hi = bf16(p)`` and
    ``lo = bf16(p - hi)``, both multiplied into the fp32 accumulator; l
    the fp32 sum of the unsplit p; the output acc / max(l, 1e-30) rounded
    to bf16.  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), all bfloat16."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"mha_tiled_ref: {name} is {t.dtype}; it "
                             f"mirrors the bf16 kernel and takes bfloat16")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = _scale(d)
    # (b, hkv, group, s, d): a q head's kv head is h // group
    qf = q.float().reshape(b, hkv, group, s, d)
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, hkv, group, s, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, s, d), device=q.device)
    for k0 in range(0, k.shape[2], BLOCK_K):
        kt = k[:, :, None, k0:k0 + BLOCK_K].float()
        vt = v[:, :, None, k0:k0 + BLOCK_K].float()
        sc = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2], device=q.device)
            sc = sc.masked_fill(cols[None, :] > rows, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi, lo = _split_p(p)
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, hq, s, d).to(torch.bfloat16)
