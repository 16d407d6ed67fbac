"""Wrapper of the CUDA spectrum-scale kernel (csrc/sino_filter.cu)."""
from __future__ import annotations

import ctypes

import torch

from .. import build

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_void_p)


def scale_spectrum_cuda(spec: torch.Tensor, filt: torch.Tensor
                        ) -> torch.Tensor:
    """spec (F, NF) complex64 × filt (NF,) float32, contiguous on one
    CUDA device -> new (F, NF) complex64."""
    build.require(spec, "scale_spectrum spec", (torch.complex64,),
                  (None, None))
    rows, nf = spec.shape
    build.require(filt, "scale_spectrum filt", (torch.float32,), (nf,),
                  spec.device)
    if spec.numel() >= 2**31:
        raise ValueError(f"scale_spectrum: {spec.numel()} bins, the kernel "
                         f"indexes bins in 32 bits (< 2**31)")
    out = torch.empty_like(spec)
    if spec.numel() == 0:
        return out
    fn = build.function("scale_spectrum", _ARGS)
    err = fn(build.ptr(spec), build.ptr(filt), build.ptr(out), rows, nf,
             build.stream(spec.device))
    build.check(err, "scale_spectrum")
    scale_spectrum_cuda.launches += 1
    return out


scale_spectrum_cuda.launches = 0
