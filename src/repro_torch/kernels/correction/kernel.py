"""Wrapper of the CUDA correction kernel (csrc/correction.cu)."""
from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Sequence

import torch

from .. import build
from .ref import EPS, HI

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_void_p)
_ENTRY = {torch.uint16: "correct_u16", torch.float32: "correct_f32"}


def correct_cuda(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
                 counts: Optional[Sequence[int]] = None,
                 eps: float = EPS, hi: float = HI) -> torch.Tensor:
    """raw (F, Y, X) uint16 or float32, all contiguous on one CUDA device
    -> (F, Y, X) float32.

    One scan: dark/flat (Y, X) float32 and no ``counts``.  A gang of J
    scans in one launch: raw holds member j's ``counts[j]`` frames after
    member j - 1's, and dark/flat (J, Y, X) float32 are each member's
    own."""
    build.require(raw, "correct raw", tuple(_ENTRY), (None, None, None))
    f, y, x = raw.shape
    if counts is None:
        counts, cal = [f], (y, x)
    else:
        counts, cal = list(counts), (len(counts), y, x)
    j = len(counts)
    if j < 1 or j > 65535 or min(counts) < 0 or sum(counts) != f:
        raise ValueError(f"correct: counts {counts} do not split {f} "
                         f"frames into 1 to 65535 members")
    build.require(dark, "correct dark", (torch.float32,), cal, raw.device)
    build.require(flat, "correct flat", (torch.float32,), cal, raw.device)
    out = torch.empty(raw.shape, dtype=torch.float32, device=raw.device)
    if raw.numel() == 0:
        return out
    offsets = None if j == 1 else torch.tensor(
        [0, *itertools.accumulate(counts)], dtype=torch.int64,
        device=raw.device)
    fn = build.function(_ENTRY[raw.dtype], _ARGS)
    err = fn(build.ptr(raw), build.ptr(dark), build.ptr(flat),
             build.ptr(out), None if offsets is None else build.ptr(offsets),
             j, max(counts), y * x, eps, hi, build.stream(raw.device))
    build.check(err, "correct")
    correct_cuda.launches += 1
    return out


correct_cuda.launches = 0
