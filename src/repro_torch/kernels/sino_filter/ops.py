"""Public op: rFFT (cuFFT on the card, via torch.fft) + the spectrum
scale + irFFT: the CUDA spectrum scale on a CUDA tensor, its plain
PyTorch version on a CPU tensor or when asked for it."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import tally
from .kernel import cost, scale_spectrum_cuda
from .ref import scale_spectrum_batched_ref, scale_spectrum_ref


def filter_sino(sino: torch.Tensor, filt: torch.Tensor, *,
                counts: Optional[Sequence[int]] = None,
                use_pallas: bool = True) -> torch.Tensor:
    """Apply a precomputed rfft-domain filter along the detector axis.

    sino: (..., n_det); filt: (n_rfft_bins,).  With ``counts``, a gang
    of J scans in one call: sino (sum(counts), ..., n_det) holds the
    members' frames one after another and filt (J, n_rfft_bins) is each
    member's own filter.

    ``use_pallas`` asks for the hand-written kernel (the JAX package's
    parameter name); a CUDA tensor with ``use_pallas=True`` launches it
    once (for all members) or raises.
    """
    n_det = sino.shape[-1]
    nf = filt.shape[-1]
    rows = sino.numel() // max(n_det, 1)
    members = 1 if counts is None else len(counts)
    if counts is not None:                      # frames -> spectrum rows
        per_frame = int(np.prod(sino.shape[1:-1], dtype=np.int64))
        counts = [c * per_frame for c in counts]
    lead = sino.shape[:-1]
    n_fft = 2 * (nf - 1)
    spec = torch.fft.rfft(sino.reshape((-1, n_det)), n=n_fft, dim=-1)
    if not use_pallas or sino.device.type == "cpu":
        with tally.plain_version("spectrum_scale",
                                 lambda: cost(rows, nf, members)):
            scaled = (scale_spectrum_ref(spec, filt) if counts is None
                      else scale_spectrum_batched_ref(spec, filt, counts))
    else:
        scaled = scale_spectrum_cuda(
            spec, filt.to(sino.device, torch.float32).contiguous(), counts)
    del spec
    out = torch.fft.irfft(scaled, n=n_fft, dim=-1)
    return out[..., :n_det].reshape(lead + (n_det,)).to(sino.dtype)
