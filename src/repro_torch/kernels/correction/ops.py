"""Public op for the fused correction: the CUDA kernel on a CUDA tensor,
the plain PyTorch version on a CPU tensor or when asked for it."""
from __future__ import annotations

import torch

from .kernel import correct_cuda
from .ref import EPS, HI, correct_ref


def correct(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
            eps: float = EPS, hi: float = HI, *,
            use_pallas: bool = True) -> torch.Tensor:
    """(..., Y, X) raw + (Y, X) dark/flat -> (..., Y, X) −log corrected.

    ``use_pallas`` (the JAX package's name, kept so its process lists
    load unchanged) asks for the hand-written kernel; False asks for the
    plain version.  A CUDA tensor with ``use_pallas=True`` launches the
    kernel or raises."""
    lead = raw.shape[:-2]
    y, x = raw.shape[-2:]
    flatr = raw.reshape((-1, y, x))
    if use_pallas and raw.device.type != "cpu":
        out = correct_cuda(flatr.contiguous(),
                           dark.to(raw.device, torch.float32).contiguous(),
                           flat.to(raw.device, torch.float32).contiguous(),
                           eps, hi)
    else:
        out = correct_ref(flatr, dark[None], flat[None], eps, hi)
    return out.reshape(lead + (y, x))
