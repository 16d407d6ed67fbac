"""Wrapper of the CUDA flash-attention kernel (csrc/flash_attention.cu)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import build, tally

#: head dims the kernel is compiled for (the reference's tests use 16,
#: 32 and 64; every configuration of the repo uses 64 or 128)
HEAD_DIMS = (16, 32, 64, 128)
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)
_DTYPES = (torch.float32, torch.bfloat16)


def cost(b: int, hq: int, hkv: int, s: int, d: int, itemsize: int,
         causal: bool = True, sk: int | None = None) -> dict[str, float]:
    """Least work of one call with ``s`` queries and ``sk`` keys (``s``
    when not given): q, k, v read and the output written once; each
    (query, key) pair it attends (c <= r when causal, every one of the
    ``s * sk`` otherwise) costs 2D operations for q.k and 2D for p.v."""
    sk = s if sk is None else sk
    pairs = s * (s + 1) / 2 if causal else s * sk
    return {"flops": float(4 * b * hq * d * pairs),
            "bytes": float(itemsize * b * d * (2 * hq * s + 2 * hkv * sk))}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), float32 or bfloat16,
    contiguous on one CUDA device -> (B, Hq, Sq, D) in q's dtype.  Sk may
    differ from Sq (cross-attention) only when ``causal`` is false.

    Raises under autograd (grad enabled and q, k or v requiring grad):
    the kernel has no backward, so its output would carry no gradient to
    q, k and v.  Neither has the reference's: its Pallas kernel cannot be
    differentiated (``pallas_call`` has no transpose rule), and the
    reference trains with ``use_flash=False``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward, so its output "
            "would carry no gradient to q, k and v (the reference's Pallas "
            "kernel has none either); train with use_flash=False, or call "
            "it under torch.no_grad()")
    build.require(q, "flash_attention q", _DTYPES, (None,) * 4)
    b, hq, s, d = q.shape
    build.require(k, "flash_attention k", (q.dtype,), (b, None, None, d),
                  q.device)
    hkv, sk = k.shape[1], k.shape[2]
    if causal and sk != s:
        raise ValueError(f"flash_attention: k has {sk} positions and q {s}; "
                         f"causal attention takes one length for both")
    if sk == 0 and s:
        raise ValueError("flash_attention: k has no positions")
    build.require(v, "flash_attention v", (q.dtype,), tuple(k.shape),
                  q.device)
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple "
                         f"of {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}, the kernel takes "
                         f"{HEAD_DIMS}")
    if max(b, (s + 63) // 64) > 65535:
        raise ValueError(f"flash_attention: batch {b} or length {s} exceeds "
                         f"one launch's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = float(np.float32(1.0 / math.sqrt(d)))
    fn = build.function("flash_attention", _ARGS)
    with build.on(q.device):
        err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b,
                 hq, hkv, s, sk, d, int(causal),
                 int(q.dtype == torch.bfloat16), scale,
                 build.stream(q.device))
    build.check(err, "flash_attention")
    tally.note("flash_attention", lambda: cost(
        b, hq, hkv, s, d, q.element_size(), causal, sk), flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
