"""Public op: rFFT (cuFFT, via torch.fft) + the CUDA spectrum scale +
irFFT on a CUDA tensor; the plain PyTorch version on a CPU tensor or
when asked for it."""
from __future__ import annotations

import torch

from .kernel import scale_spectrum_cuda
from .ref import filter_sino_ref


def filter_sino(sino: torch.Tensor, filt: torch.Tensor, *,
                use_pallas: bool = True) -> torch.Tensor:
    """Apply a precomputed rfft-domain filter along the detector axis.

    sino: (..., n_det); filt: (n_rfft_bins,).  ``use_pallas`` asks for
    the hand-written kernel (the JAX package's parameter name); a CUDA
    tensor with ``use_pallas=True`` launches it or raises.
    """
    if not use_pallas or sino.device.type == "cpu":
        return filter_sino_ref(sino, filt)
    n_det = sino.shape[-1]
    lead = sino.shape[:-1]
    n_fft = 2 * (filt.shape[-1] - 1)
    spec = torch.fft.rfft(sino.reshape((-1, n_det)), n=n_fft, dim=-1)
    scaled = scale_spectrum_cuda(
        spec, filt.to(sino.device, torch.float32).contiguous())
    del spec
    out = torch.fft.irfft(scaled, n=n_fft, dim=-1)
    return out[..., :n_det].reshape(lead + (n_det,)).to(sino.dtype)
