"""Public attention entry point used by the models.

Dispatch as the JAX package's: the hand-written flash kernel when it is
asked for (``use_pallas``, the reference's name) on a CUDA tensor;
otherwise the chunked online-softmax version for long sequences and the
plain version below that.  A CPU tensor always takes a plain version.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from .kernel import flash_attention_cuda
from .ref import mha_chunked_ref, mha_ref

#: sequences at or above this length route to the chunked
#: online-softmax path (O(S·bq) memory) instead of materialised scores.
CHUNKED_THRESHOLD = 8192


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, use_pallas: bool = False) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D); Sk may
    differ from Sq when ``causal`` is false.  A CUDA tensor with
    ``use_pallas=True`` launches the kernel or raises.  DTensors (the
    dry-run) split over batch and heads attend shard by shard."""
    if isinstance(q, DTensor) and _batch_head_split(q):
        return _on_shards(q, k, v, causal=causal, use_pallas=use_pallas)
    if use_pallas and q.device.type != "cpu":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    if q.shape[2] >= CHUNKED_THRESHOLD and q.shape[2] == k.shape[2]:
        return mha_chunked_ref(q, k, v, causal=causal)
    return mha_ref(q, k, v, causal=causal)


def _batch_head_split(q: DTensor) -> bool:
    """q is split over batch and heads only (each shard holds whole
    sequences of whole heads)."""
    return all(isinstance(p, Replicate) or (p.is_shard() and p.dim < 2)
               for p in q.placements)


def _on_shards(q: DTensor, k: DTensor, v: DTensor, *, causal: bool,
               use_pallas: bool) -> DTensor:
    """Attention over each shard of q's batch × heads: k and v are
    widened to q's heads (GQA) and placed as q is, so each shard attends
    on its own, as a sharded program does, without the gathers DTensor
    would insert for the batched products' merged dims."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    k = k.redistribute(q.device_mesh, q.placements)
    v = v.redistribute(q.device_mesh, q.placements)
    out = attention(q.to_local(), k.to_local(), v.to_local(), causal=causal,
                    use_pallas=use_pallas)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)
