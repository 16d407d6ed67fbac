"""Plain PyTorch version: ramp (Ram-Lak / Shepp-Logan / cosine / Hann)
sinogram filtering for FBP, via rFFT along the detector axis."""
from __future__ import annotations

import numpy as np
import torch


def make_filter(n_det: int, kind: str = "ramlak",
                pad_to: int | None = None) -> np.ndarray:
    """Frequency response |f| × window, length n_fft//2+1 (rfft bins);
    built on the host."""
    n_fft = pad_to or _next_pow2(2 * n_det)
    freqs = np.fft.rfftfreq(n_fft)              # [0, 0.5] cycles/sample
    ramp = freqs                                # |ω| of the FBP integral;
    # pairs with the π/n_angles backprojection scale (ops.backproject)
    if kind == "ramlak":
        win = np.ones_like(ramp)
    elif kind == "shepp":
        win = np.sinc(freqs)
    elif kind == "cosine":
        win = np.cos(np.pi * freqs)
    elif kind == "hann":
        win = 0.5 * (1 + np.cos(2 * np.pi * freqs))
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return (ramp * win).astype(np.float32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def scale_spectrum_ref(spec: torch.Tensor, filt: torch.Tensor
                       ) -> torch.Tensor:
    """(..., NF) complex spectrum × (NF,) real filter."""
    return spec * filt.to(spec.device, spec.real.dtype)


def filter_sino_ref(sino: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """(..., n_det) real sinogram rows × precomputed rfft filter."""
    n_det = sino.shape[-1]
    n_fft = 2 * (filt.shape[-1] - 1)
    spec = torch.fft.rfft(sino, n=n_fft, dim=-1)
    out = torch.fft.irfft(scale_spectrum_ref(spec, filt), n=n_fft, dim=-1)
    return out[..., :n_det].to(sino.dtype)
