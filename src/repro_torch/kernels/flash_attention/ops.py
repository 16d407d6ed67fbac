"""Public attention entry point used by the models.

Dispatch as the JAX package's: the hand-written flash kernel when it is
asked for (``use_pallas``, the reference's name) on a CUDA tensor;
otherwise the chunked online-softmax version for long sequences and the
plain version below that.  A CPU tensor always takes a plain version.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import mha_chunked_ref, mha_ref

#: sequences at or above this length route to the chunked
#: online-softmax path (O(S·bq) memory) instead of materialised scores.
CHUNKED_THRESHOLD = 8192


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, use_pallas: bool = False) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D); Sk may
    differ from Sq when ``causal`` is false.  A CUDA tensor with
    ``use_pallas=True`` launches the kernel or raises."""
    if use_pallas and q.device.type != "cpu":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    if q.shape[2] >= CHUNKED_THRESHOLD and q.shape[2] == k.shape[2]:
        return mha_chunked_ref(q, k, v, causal=causal)
    return mha_ref(q, k, v, causal=causal)
