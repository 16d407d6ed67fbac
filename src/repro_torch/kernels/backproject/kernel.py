"""Wrapper of the CUDA backprojection kernel (csrc/backproject.cu)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


def backproject_cuda(sino: torch.Tensor, cos_t: torch.Tensor,
                     sin_t: torch.Tensor, out_size: int,
                     centre: float | None = None) -> torch.Tensor:
    """sino (S, A, D) float32 + cos/sin tables (A,) float32, contiguous on
    one CUDA device -> (S, out_size, out_size) float32, scaled by π/A."""
    build.require(sino, "backproject sino", (torch.float32,),
                  (None, None, None))
    n_sl, n_angles, n_det = sino.shape
    build.require(cos_t, "backproject cos", (torch.float32,), (n_angles,),
                  sino.device)
    build.require(sin_t, "backproject sin", (torch.float32,), (n_angles,),
                  sino.device)
    if -(-n_sl // 4) > 65535:
        raise ValueError(f"backproject: {n_sl} slices exceed one launch's "
                         f"grid (65535 groups of at most 4)")
    if n_angles == 0:
        raise ValueError("backproject: no angles")
    if centre is None:
        centre = (n_det - 1) / 2.0
    # the staged window's slack holds while t's rounding error stays far
    # below a bin
    reach = (out_size - 1) / 2 * math.sqrt(2) + abs(centre)
    if reach >= 2**17:
        raise ValueError(f"backproject: positions up to |t| = {reach:.0f} "
                         f"exceed the kernel's range (2**17)")
    out = torch.empty((n_sl, out_size, out_size), dtype=torch.float32,
                      device=sino.device)
    if out.numel() == 0:
        return out
    scale = float(np.float32(math.pi / n_angles))
    fn = build.function("backproject", _ARGS)
    err = fn(build.ptr(sino), build.ptr(cos_t), build.ptr(sin_t),
             build.ptr(out), n_sl, n_angles, n_det, out_size,
             float(centre), scale, build.stream(sino.device))
    build.check(err, "backproject")
    backproject_cuda.launches += 1
    return out


backproject_cuda.launches = 0
