"""Plain PyTorch version: fused dark/flat-field correction + linearisation.

corrected = clip((raw - dark) / max(flat - dark, eps), eps, hi)
out       = -log(corrected)

The first plugin of every full-field chain (paper §II.A: "a simple
correction, linearisation").
"""
from __future__ import annotations

from typing import Sequence

import torch

EPS = 1e-6
HI = 10.0  # transmission clip ceiling (dead/hot pixels)


def correct_ref(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
                eps: float = EPS, hi: float = HI) -> torch.Tensor:
    raw = raw.to(torch.float32)
    dark = dark.to(torch.float32)
    flat = flat.to(torch.float32)
    denom = torch.clamp(flat - dark, min=eps)
    trans = torch.clamp((raw - dark) / denom, eps, hi)
    return -torch.log(trans)


def correct_batched_ref(raw: torch.Tensor, dark: torch.Tensor,
                        flat: torch.Tensor, counts: Sequence[int],
                        eps: float = EPS, hi: float = HI) -> torch.Tensor:
    """A gang of scans: member j's ``counts[j]`` frames of raw (after
    member j - 1's) with its own dark[j]/flat[j] of (J, Y, X)."""
    if sum(counts) != raw.shape[0] or len(counts) != dark.shape[0]:
        raise ValueError(f"correct_batched: counts {list(counts)} do not "
                         f"split {raw.shape[0]} frames over "
                         f"{dark.shape[0]} members")
    outs, lo = [], 0
    for j, n in enumerate(counts):
        outs.append(correct_ref(raw[lo:lo + n], dark[j][None],
                                flat[j][None], eps, hi))
        lo += n
    return torch.cat(outs)
