"""Public op for the fused correction: the CUDA kernel on a CUDA tensor,
the plain PyTorch version on a CPU tensor or when asked for it."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .kernel import correct_cuda
from .ref import EPS, HI, correct_batched_ref, correct_ref


def correct(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
            eps: float = EPS, hi: float = HI, *,
            counts: Optional[Sequence[int]] = None,
            use_pallas: bool = True) -> torch.Tensor:
    """(..., Y, X) raw + (Y, X) dark/flat -> (..., Y, X) −log corrected.

    With ``counts``, a gang of J scans in one call: raw (sum(counts), Y,
    X) holds the members' frames one after another and dark/flat (J, Y,
    X) are each member's own.

    ``use_pallas`` (the JAX package's name, kept so its process lists
    load unchanged) asks for the hand-written kernel; False asks for the
    plain version.  A CUDA tensor with ``use_pallas=True`` launches the
    kernel once (for all members) or raises."""
    if use_pallas and raw.device.type != "cpu":
        lead, (y, x) = raw.shape[:-2], raw.shape[-2:]
        out = correct_cuda(raw.reshape((-1, y, x)).contiguous(),
                           dark.to(raw.device, torch.float32).contiguous(),
                           flat.to(raw.device, torch.float32).contiguous(),
                           counts, eps, hi)
        return out.reshape(lead + (y, x))
    if counts is not None:
        return correct_batched_ref(raw, dark, flat, counts, eps, hi)
    return correct_ref(raw, dark, flat, eps, hi)
