"""Wrapper of the CUDA spectrum-scale kernel (csrc/sino_filter.cu)."""
from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Sequence

import torch

from .. import build, tally

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 3 + (
    ctypes.c_void_p,)


def cost(rows: int, nf: int, members: int = 1) -> dict[str, float]:
    """Least work of one call: every complex bin read and written once
    (8 bytes each way), each member's filter row read once, and two
    multiplies per bin."""
    return {"flops": float(rows * nf * 2),
            "bytes": float(rows * nf * 8 * 2 + members * nf * 4)}


def scale_spectrum_cuda(spec: torch.Tensor, filt: torch.Tensor,
                        counts: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """spec (F, NF) complex64, contiguous on one CUDA device -> new (F,
    NF) complex64.

    One scan: filt (NF,) float32 and no ``counts``.  A gang of J scans
    in one launch: spec holds member j's ``counts[j]`` rows after member
    j - 1's, and filt (J, NF) float32 is each member's own filter.  The
    kernel indexes bins in 32 bits below 2**31 bins and in 64 bits at or
    above it."""
    build.require(spec, "scale_spectrum spec", (torch.complex64,),
                  (None, None))
    rows, nf = spec.shape
    if counts is None:
        counts, shape = [rows], (nf,)
    else:
        counts, shape = list(counts), (len(counts), nf)
    j = len(counts)
    if j < 1 or j > 65535 or min(counts) < 0 or sum(counts) != rows:
        raise ValueError(f"scale_spectrum: counts {counts} do not split "
                         f"{rows} rows into 1 to 65535 members")
    build.require(filt, "scale_spectrum filt", (torch.float32,), shape,
                  spec.device)
    out = torch.empty_like(spec)
    if spec.numel() == 0:
        return out
    # equal members (one scan among them) need no offsets
    offsets = None if len(set(counts)) == 1 else torch.tensor(
        [0, *itertools.accumulate(counts)], dtype=torch.int64,
        device=spec.device)
    fn = build.function("scale_spectrum", _ARGS)
    with build.on(spec.device):
        err = fn(build.ptr(spec), build.ptr(filt), build.ptr(out),
                 None if offsets is None else build.ptr(offsets), j,
                 max(counts), nf, build.stream(spec.device))
    build.check(err, "scale_spectrum")
    tally.note("spectrum_scale", lambda: cost(rows, nf, j),
               scale_spectrum_cuda)
    return out


scale_spectrum_cuda.launches = 0
