"""Plain PyTorch version of parallel-beam filtered backprojection, and
the CUDA kernel's own arithmetic (tests and the card check only)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

#: elements of one (slices, angle chunk, N*N) temporary; bounds memory
CHUNK_ELEMS = 1 << 24


def backproject_ref(sino: torch.Tensor, angles: torch.Tensor, out_size: int,
                    centre: float | None = None) -> torch.Tensor:
    """(..., n_angles, n_det) filtered sinograms -> (..., N, N) images.

    out(y, x) = (π / n_angles) · Σ_θ lerp(sino_zeropad[θ], t),
    t = (x - c)·cosθ + (y - c)·sinθ + centre,  c = (N - 1) / 2.

    Boundary convention: the detector row is zero-padded, so rays whose
    t falls in (-1, 0) or (n_det-1, n_det) taper linearly to zero and
    rays further outside contribute exactly 0.  The angle sum runs over
    chunks of angles so the temporaries stay within ``CHUNK_ELEMS``.
    """
    sino = sino.to(torch.float32)
    lead = sino.shape[:-2]
    n_angles, n_det = sino.shape[-2:]
    rows = F.pad(sino.reshape((-1, n_angles, n_det)), (1, 1))
    n_sl = rows.shape[0]
    if centre is None:
        centre = (n_det - 1) / 2.0
    c = (out_size - 1) / 2.0
    dev = sino.device
    xs = torch.arange(out_size, dtype=torch.float32, device=dev) - c
    ys = torch.arange(out_size, dtype=torch.float32, device=dev) - c
    theta = angles.to(dev, torch.float32)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    acc = torch.zeros((n_sl, out_size * out_size), dtype=torch.float32,
                      device=dev)
    chunk = max(1, CHUNK_ELEMS // (n_sl * out_size * out_size))
    for a0 in range(0, n_angles, chunk):
        ct = cos_t[a0:a0 + chunk, None, None]
        st = sin_t[a0:a0 + chunk, None, None]
        na = ct.shape[0]
        t = xs[None, None, :] * ct + ys[None, :, None] * st + centre
        tp = torch.clamp(t + 1.0, 0.0, n_det + 1.0)   # padded coords
        t0 = torch.floor(tp)
        frac = (tp - t0).reshape(1, na, -1)
        i0 = torch.clamp(t0.to(torch.int64), 0, n_det)
        i1 = torch.clamp(i0 + 1, 0, n_det + 1)
        inside = ((t > -1.0) & (t < n_det)).reshape(1, na, -1)
        seg = rows[:, a0:a0 + na]
        g0 = torch.gather(seg, 2, i0.reshape(1, na, -1).expand(n_sl, -1, -1))
        g1 = torch.gather(seg, 2, i1.reshape(1, na, -1).expand(n_sl, -1, -1))
        val = g0 * (1 - frac) + g1 * frac
        acc += torch.where(inside, val, 0.0).sum(dim=1)
    out = acc * (math.pi / n_angles)
    return out.reshape(lead + (out_size, out_size))


def _position(xs: torch.Tensor, ys: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, centre: float) -> torch.Tensor:
    """t for every (y, x) at one angle, rounded as the reference rounds
    it: ``fl(fl(fl(x·cos) + fl(y·sin)) + centre)``, (len(ys), len(xs))."""
    return (xs[None, :] * cos + ys[:, None] * sin) + centre


def backproject_tiled_ref(sino: torch.Tensor, angles: torch.Tensor,
                          out_size: int, centre: float | None = None, *,
                          rows=None) -> torch.Tensor:
    """The CUDA kernel's arithmetic, step for step (tests and the card
    check only): the float32 position in the reference's rounding,
    ``fl(fl(fl(x·cosθ) + fl(y·sinθ)) + centre)``; ``tp = fl(t + 1)``, its
    floor ``t0``, ``f = fl(tp - t0)`` and ``fl(1 - f)``; bins ``t0 - 1``
    and ``t0`` of the detector row, zero outside it (so a ray outside
    (-1, D) adds two zeros); per slice one accumulator over the angles in
    order, ``acc = fma(s1, f, fma(s0, 1 - f, acc))``, each fused
    multiply-add emulated in float64 and rounded once to float32; the
    sum times the float32 π/A.

    (..., n_angles, n_det) -> (..., len(rows), N), where ``rows`` (image
    rows y, default all N) picks the rows to compute."""
    sino = sino.to(torch.float32)
    lead = sino.shape[:-2]
    n_angles, n_det = sino.shape[-2:]
    # padded index i holds detector bin i - 1
    padded = F.pad(sino.reshape((-1, n_angles, n_det)), (1, 1)).double()
    if centre is None:
        centre = (n_det - 1) / 2.0
    c = (out_size - 1) / 2.0
    dev = sino.device
    xs = torch.arange(out_size, dtype=torch.float32, device=dev) - c
    ys = (torch.arange(out_size) if rows is None else torch.as_tensor(rows)
          ).to(dev, torch.float32) - c
    theta = angles.to(dev, torch.float32)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    acc = torch.zeros((padded.shape[0], ys.shape[0] * out_size),
                      dtype=torch.float32, device=dev)
    for a in range(n_angles):
        tp = _position(xs, ys, cos_t[a], sin_t[a], centre) + 1.0
        t0 = torch.floor(tp)
        frac = (tp - t0).reshape(-1)
        f, f0 = frac.double(), (1.0 - frac).double()
        i0 = t0.reshape(-1).to(torch.int64)
        row = padded[:, a]
        g0 = row[:, torch.clamp(i0, 0, n_det + 1)]
        g1 = row[:, torch.clamp(i0 + 1, 0, n_det + 1)]
        acc = (acc.double() + g0 * f0).float()
        acc = (acc.double() + g1 * f).float()
    out = acc * float(np.float32(math.pi / n_angles))
    return out.reshape(lead + (ys.shape[0], out_size))
