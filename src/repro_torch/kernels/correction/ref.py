"""Plain PyTorch version: fused dark/flat-field correction + linearisation.

corrected = clip((raw - dark) / max(flat - dark, eps), eps, hi)
out       = -log(corrected)

The first plugin of every full-field chain (paper §II.A: "a simple
correction, linearisation").
"""
from __future__ import annotations

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
