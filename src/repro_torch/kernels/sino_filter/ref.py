"""Plain PyTorch version: ramp (Ram-Lak / Shepp-Logan / cosine / Hann)
sinogram filtering for FBP, via rFFT along the detector axis."""
from __future__ import annotations

from typing import Sequence

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


def member_rows(counts: Sequence[int], n_rows: int, n_members: int,
                device: torch.device) -> torch.Tensor:
    """The member of each row of a gang: member j's ``counts[j]`` rows
    follow member j - 1's."""
    counts = list(counts)
    if sum(counts) != n_rows or len(counts) != n_members or \
            min(counts, default=0) < 0:
        raise ValueError(f"counts {counts} do not split {n_rows} rows over "
                         f"{n_members} members")
    return torch.repeat_interleave(
        torch.arange(n_members, device=device),
        torch.tensor(counts, device=device))


def scale_spectrum_batched_ref(spec: torch.Tensor, filts: torch.Tensor,
                               counts: Sequence[int]) -> torch.Tensor:
    """A gang's (rows, NF) spectrum × each member's filter row of (J,
    NF): member j's ``counts[j]`` rows after member j - 1's."""
    rows = member_rows(counts, spec.shape[0], filts.shape[0], spec.device)
    return spec * filts.to(spec.device, spec.real.dtype)[rows]


def filter_sino_batched_ref(sino: torch.Tensor, filts: torch.Tensor,
                            counts: Sequence[int]) -> torch.Tensor:
    """A gang of sinogram stacks, (F, ..., n_det), filtered in one pass:
    member j's ``counts[j]`` frames (after member j - 1's) by its own
    filter ``filts[j]`` of (J, n_rfft_bins)."""
    n_det = sino.shape[-1]
    n_fft = 2 * (filts.shape[-1] - 1)
    per_frame = int(np.prod(sino.shape[1:-1], dtype=np.int64))
    spec = torch.fft.rfft(sino.reshape((-1, n_det)), n=n_fft, dim=-1)
    scaled = scale_spectrum_batched_ref(
        spec, filts, [c * per_frame for c in counts])
    out = torch.fft.irfft(scaled, n=n_fft, dim=-1)
    return out[..., :n_det].reshape(sino.shape).to(sino.dtype)
