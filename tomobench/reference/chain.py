"""The plain reference of the full-field chain, in PyTorch, slice by slice.

It computes what the configuration's process list states, from the raw
scan alone (the same host arrays the program's loader is given), and
takes nothing the program made: dark/flat correction and linearisation,
ring removal, the frequency-domain ramp filter, filtered backprojection.
Every slice (detector row) is independent of every other, so the
reference computes any chosen rows of a band at the band's full size
(all angles, all columns, the whole image).

Conventions (frozen with the scans, ``tomobench.scans``): angles
``linspace(0, π, A, endpoint=False)`` rounded to float32; a pixel's ray
position ``t = (x - c)·cos θ + (y - c)·sin θ + (n_det - 1) / 2`` with
``c = (N - 1) / 2``; the detector row zero beyond its ends, so a ray in
(-1, 0) or (n_det - 1, n_det) tapers linearly to 0; the sum over angles
times ``π / A``, divided by the scan's ``mu``.

``mode`` sets the precision: ``"fp32"`` is the reference; ``"bf16"``
(the control) keeps every value of the data path in bfloat16 (the
corrected and filtered sinograms, the interpolation and the sum over
angles) with the ray geometry in float32; ``"bf16_storage"`` rounds
each stage's output to bfloat16 and computes in float32.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6          # floor of flat - dark, and of the transmission
HI = 10.0           # ceiling of the transmission (hot pixels)
#: elements of one (slices, angles, pixels) temporary of the backprojection
CHUNK = 1 << 26

MODES = ("fp32", "bf16", "bf16_storage")


def _dt(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return torch.bfloat16 if mode == "bf16" else torch.float32


def _store(x: torch.Tensor, mode: str) -> torch.Tensor:
    """A stage's output as the mode keeps it between stages."""
    if mode == "fp32":
        return x.to(torch.float32)
    return x.to(torch.bfloat16)


def correct(raw: torch.Tensor, dark: torch.Tensor, flat: torch.Tensor,
            mode: str = "fp32") -> torch.Tensor:
    """−log(clip((raw − dark) / max(flat − dark, EPS), EPS, HI))."""
    dt = _dt(mode)
    raw, dark, flat = raw.to(dt), dark.to(dt), flat.to(dt)
    trans = (raw - dark) / torch.clamp(flat - dark, min=EPS)
    return _store(-torch.log(torch.clamp(trans, EPS, HI)), mode)


def ring_removal(sino: torch.Tensor, kernel: int, strength: float,
                 mode: str = "fp32") -> torch.Tensor:
    """(..., A, X) minus ``strength`` × (column mean over the angles −
    its moving mean over ``kernel`` columns, edges repeated)."""
    dt = _dt(mode)
    s = sino.to(dt)
    col = s.mean(dim=-2, keepdim=True)                     # (..., 1, X)
    pad = kernel // 2
    padded = torch.cat([col[..., :1].expand(*col.shape[:-1], pad), col,
                        col[..., -1:].expand(*col.shape[:-1], pad)], dim=-1)
    smooth = padded.unfold(-1, kernel, 1).mean(dim=-1)
    return _store(s - strength * (col - smooth), mode)


def ramp_filter(n_det: int, kind: str, cutoff: float) -> torch.Tensor:
    """The rfft-domain response (float32, ``n_fft // 2 + 1`` bins, n_fft
    the power of two at or above 2·n_det): |f| times the window, zero
    above ``cutoff`` × Nyquist."""
    n_fft = 1 << max(0, (2 * n_det - 1).bit_length())
    f = np.fft.rfftfreq(n_fft)
    win = {"ramlak": np.ones_like(f), "shepp": np.sinc(f),
           "cosine": np.cos(np.pi * f),
           "hann": 0.5 * (1 + np.cos(2 * np.pi * f))}[kind]
    resp = (f * win).astype(np.float32)
    keep = np.linspace(0.0, 1.0, resp.shape[0], dtype=np.float32) <= cutoff
    return torch.as_tensor(resp * keep)


def sino_filter(sino: torch.Tensor, kind: str, cutoff: float,
                mode: str = "fp32") -> torch.Tensor:
    """Each sinogram row convolved with the ramp: rfft, times the
    response, irfft, cut back to n_det (torch.fft has no bfloat16: the
    control's values are bfloat16 before and after)."""
    n_det = sino.shape[-1]
    filt = ramp_filter(n_det, kind, cutoff).to(sino.device)
    n_fft = 2 * (filt.shape[0] - 1)
    spec = torch.fft.rfft(sino.to(torch.float32), n=n_fft, dim=-1)
    out = torch.fft.irfft(spec * filt, n=n_fft, dim=-1)[..., :n_det]
    return _store(out, mode)


def backproject(sino: torch.Tensor, out_size: int, mu: float,
                mode: str = "fp32") -> torch.Tensor:
    """(S, A, n_det) filtered sinograms -> (S, N, N) attenuation images."""
    dt = _dt(mode)
    n_sl, n_ang, n_det = sino.shape
    dev = sino.device
    rows = F.pad(sino.to(dt), (1, 1))                # bin i at index i + 1
    theta = torch.as_tensor(np.linspace(0.0, math.pi, n_ang, endpoint=False)
                            .astype(np.float32), device=dev)
    c = (out_size - 1) / 2.0
    centre = (n_det - 1) / 2.0
    xs = torch.arange(out_size, dtype=torch.float32, device=dev) - c
    acc = torch.zeros((n_sl, out_size * out_size), dtype=dt, device=dev)
    step = max(1, CHUNK // (n_sl * out_size * out_size))
    for a0 in range(0, n_ang, step):
        cs = torch.cos(theta[a0:a0 + step])[:, None, None]
        sn = torch.sin(theta[a0:a0 + step])[:, None, None]
        na = cs.shape[0]
        t = xs[None, None, :] * cs + xs[None, :, None] * sn + centre
        inside = ((t > -1.0) & (t < n_det)).reshape(1, na, -1)
        tp = torch.clamp(t + 1.0, 0.0, n_det + 1.0)
        i0 = torch.floor(tp)
        frac = (tp - i0).reshape(1, na, -1).to(dt)
        i0 = torch.clamp(i0.to(torch.int64), 0, n_det).reshape(1, na, -1)
        seg = rows[:, a0:a0 + na]
        g0 = torch.gather(seg, 2, i0.expand(n_sl, -1, -1))
        g1 = torch.gather(seg, 2, (i0 + 1).expand(n_sl, -1, -1))
        val = g0 + frac * (g1 - g0)
        acc += torch.where(inside, val, torch.zeros((), dtype=dt,
                                                    device=dev)).sum(dim=1)
    out = acc.to(torch.float32) * (math.pi / n_ang) / mu
    return out.reshape(n_sl, out_size, out_size)


def chain_params(process_list: Sequence[dict]) -> dict:
    """The parameters the reference needs from the configuration's
    process list (the same entries the program's chain is built from)."""
    by = {e["plugin"]: e.get("params", {}) for e in process_list}
    ring = by.get("ring_removal")
    filt = by["sinogram_filter"]
    return {"ring": None if ring is None else
            (int(ring.get("kernel", 9)), float(ring.get("strength", 1.0))),
            "kind": filt.get("kind", "ramlak"),
            "cutoff": float(filt.get("cutoff", 1.0)),
            "out_size": by["fbp_recon"].get("out_size")}


def reconstruct(scan: dict, rows: Sequence[int], params: dict,
                device: torch.device, mode: str = "fp32",
                cutoff: float | None = None) -> torch.Tensor:
    """Rows ``rows`` (indices into ``scan["data"]``'s y axis) of the
    scan reconstructed: (len(rows), N, N) float32 on ``device``.
    ``cutoff`` overrides the filter's (a sweep variant's own)."""
    idx = list(rows)
    data = scan["data"]
    raw = torch.as_tensor(np.ascontiguousarray(
        np.stack([data[:, r, :] for r in idx])), device=device)  # (S, A, X)
    dark = torch.as_tensor(scan["dark"][idx].astype(np.float32),
                           device=device)[:, None, :]
    flat = torch.as_tensor(scan["flat"][idx].astype(np.float32),
                           device=device)[:, None, :]
    sino = correct(raw, dark, flat, mode)
    del raw
    if params["ring"] is not None:
        sino = ring_removal(sino, *params["ring"], mode=mode)
    sino = sino_filter(sino, params["kind"],
                       params["cutoff"] if cutoff is None else cutoff, mode)
    n_det = sino.shape[-1]
    return backproject(sino, params["out_size"] or n_det,
                       float(scan.get("mu", 1.0)), mode)
