"""Wrapper of the CUDA correction kernel (csrc/correction.cu)."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import EPS, HI

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p)
_ENTRY = {torch.uint16: "correct_u16", torch.float32: "correct_f32"}


def correct_cuda(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
                 eps: float = EPS, hi: float = HI) -> torch.Tensor:
    """raw (F, Y, X) uint16 or float32; dark/flat (Y, X) float32, all
    contiguous on one CUDA device -> (F, Y, X) float32."""
    build.require(raw, "correct raw", tuple(_ENTRY), (None, None, None))
    f, y, x = raw.shape
    build.require(dark, "correct dark", (torch.float32,), (y, x), raw.device)
    build.require(flat, "correct flat", (torch.float32,), (y, x), raw.device)
    out = torch.empty(raw.shape, dtype=torch.float32, device=raw.device)
    if raw.numel() == 0:
        return out
    fn = build.function(_ENTRY[raw.dtype], _ARGS)
    err = fn(build.ptr(raw), build.ptr(dark), build.ptr(flat),
             build.ptr(out), f, y * x, eps, hi, build.stream(raw.device))
    build.check(err, "correct")
    correct_cuda.launches += 1
    return out


correct_cuda.launches = 0
