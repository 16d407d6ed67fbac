"""Wrapper of the CUDA backprojection kernel (csrc/backproject.cu)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import build, tally

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
#: least fp32 work of backprojection: all slices share the geometry, so
#: the position step and the fraction (2) count once per (pixel, angle)
#: whose ray lands on the detector, and the lerp a + f(b - a) (3, the
#: multiply-add counted as 2) and the accumulation (1) once per slice
FLOPS_PER_PAIR = 2
FLOPS_PER_UPDATE = 4
#: (angles x pixels) positions evaluated at once by rays_on_detector
_CHUNK_ELEMS = 1 << 26


def rays_on_detector(cos_t: torch.Tensor, sin_t: torch.Tensor,
                     out_size: int, n_det: int,
                     centre: float | None = None) -> int:
    """(pixel, angle) pairs whose ray lands on the detector, t in (-1,
    D), with t rounded in float32 as the kernel rounds it; counted on
    the tables' device."""
    if centre is None:
        centre = (n_det - 1) / 2.0
    xs = torch.arange(out_size, dtype=torch.float32,
                      device=cos_t.device) - (out_size - 1) / 2.0
    total = torch.zeros((), dtype=torch.int64, device=cos_t.device)
    step = max(1, _CHUNK_ELEMS // max(out_size * out_size, 1))
    for a0 in range(0, cos_t.shape[0], step):
        t = (xs[None, None, :] * cos_t[a0:a0 + step, None, None]
             + xs[None, :, None] * sin_t[a0:a0 + step, None, None] + centre)
        total += ((t > -1.0) & (t < n_det)).sum()
    return int(total)


def cost(n_slices: int, n_angles: int, n_det: int, out_size: int,
         rays: int) -> dict[str, float]:
    """Least work of one call: each sinogram, table and image element
    moved once; ``rays`` (from :func:`rays_on_detector`) positions, and a
    lerp and an add per slice for each of them."""
    return {"flops": float(rays * FLOPS_PER_PAIR
                           + rays * n_slices * FLOPS_PER_UPDATE),
            "bytes": float(n_slices * n_angles * n_det * 4
                           + n_slices * out_size * out_size * 4
                           + 2 * n_angles * 4)}


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
    with build.on(sino.device):
        err = fn(build.ptr(sino), build.ptr(cos_t), build.ptr(sin_t),
                 build.ptr(out), n_sl, n_angles, n_det, out_size,
                 float(centre), scale, build.stream(sino.device))
    build.check(err, "backproject")
    tally.note("backprojection", lambda: cost(
        n_sl, n_angles, n_det, out_size,
        rays_on_detector(cos_t, sin_t, out_size, n_det, centre)),
        backproject_cuda)
    return out


backproject_cuda.launches = 0
