"""Synthetic data: Shepp–Logan-style phantoms + a parallel-beam forward
projector (bilinear Radon transform) in PyTorch.

These are the data-generation oracle for the tomography tests: phantom →
forward project → (simulated dark/flat/noise) → the Savu chain must
reconstruct something close to the phantom.  The projector runs on the
device it is given (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .geometry import ParallelGeometry

# (value, a, b, x0, y0, phi_deg) — standard Shepp-Logan ellipses
# (modified/high-contrast variant so tests have healthy SNR).
_SHEPP_LOGAN = [
    (1.00, 0.69, 0.92, 0.0, 0.0, 0),
    (-0.80, 0.6624, 0.8740, 0.0, -0.0184, 0),
    (-0.20, 0.1100, 0.3100, 0.22, 0.0, -18),
    (-0.20, 0.1600, 0.4100, -0.22, 0.0, 18),
    (0.10, 0.2100, 0.2500, 0.0, 0.35, 0),
    (0.10, 0.0460, 0.0460, 0.0, 0.10, 0),
    (0.10, 0.0460, 0.0460, 0.0, -0.10, 0),
    (0.10, 0.0460, 0.0230, -0.08, -0.605, 0),
    (0.10, 0.0230, 0.0230, 0.0, -0.606, 0),
    (0.10, 0.0230, 0.0460, 0.06, -0.605, 0),
]

#: elements of one (rows, angle chunk, samples, detector) temporary
CHUNK_ELEMS = 1 << 26


def shepp_logan(n: int, dtype=np.float32) -> np.ndarray:
    """n×n modified Shepp–Logan phantom in [0, ~1]."""
    ys, xs = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = np.zeros((n, n), dtype=np.float64)
    for val, a, b, x0, y0, phi in _SHEPP_LOGAN:
        th = math.radians(phi)
        c, s = math.cos(th), math.sin(th)
        xr = (xs - x0) * c + (ys - y0) * s
        yr = -(xs - x0) * s + (ys - y0) * c
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += val
    return img.astype(dtype)


def phantom_stack(n: int, n_rows: int, dtype=np.float32) -> np.ndarray:
    """(n_rows, n, n) phantom volume: Shepp–Logan modulated per row, so
    adjacent slices differ (tests catch axis mix-ups)."""
    base = shepp_logan(n, np.float64)
    rows = []
    for r in range(n_rows):
        scale = 0.5 + 0.5 * (r + 1) / n_rows
        rows.append(base * scale)
    return np.stack(rows).astype(dtype)


def forward_project(volume, geom: ParallelGeometry,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """(rows, H, W) volume -> (n_angles, rows, n_det) projections in the
    paper's (θ, y, x) layout, as a float32 tensor on ``device``.

    Rotation-based: for each angle the image is sampled bilinearly along
    rays (t = x·cosθ + y·sinθ, pixel units) and the samples summed.  All
    rows share each angle's sample grid, so the grid is computed once
    per chunk of angles and gathered for every row at once."""
    dev = resolve_device(device)
    vol = torch.as_tensor(np.asarray(volume, dtype=np.float32), device=dev)
    if vol.dim() == 2:
        vol = vol[None]
    n_rows, h, w = vol.shape
    n_det = geom.n_det
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cd = (n_det - 1) / 2.0
    n_s = h  # integration samples
    t = torch.arange(n_det, dtype=torch.float32, device=dev) - cd
    s = torch.arange(n_s, dtype=torch.float32, device=dev) - (n_s - 1) / 2.0
    theta = torch.as_tensor(geom.angles.astype(np.float32), device=dev)
    flat = vol.reshape(n_rows, h * w)
    out = torch.empty((geom.n_angles, n_rows, n_det), dtype=torch.float32,
                      device=dev)
    chunk = max(1, CHUNK_ELEMS // (n_rows * n_s * n_det))
    for a0 in range(0, geom.n_angles, chunk):
        ct = torch.cos(theta[a0:a0 + chunk])[:, None, None]
        st = torch.sin(theta[a0:a0 + chunk])[:, None, None]
        na = ct.shape[0]
        # point = t*(cos,sin) + s*(-sin,cos) in (x, y): (na, n_s, n_det)
        xs = t[None, None, :] * ct - s[None, :, None] * st + cx
        ys = t[None, None, :] * st + s[None, :, None] * ct + cy
        x0 = torch.floor(xs)
        y0 = torch.floor(ys)
        fx = xs - x0
        fy = ys - y0
        x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
        # bilinear weights with the outside samples zeroed, shared by rows
        w00 = torch.where(inside, (1 - fx) * (1 - fy), 0.0).reshape(-1)
        w01 = torch.where(inside, fx * (1 - fy), 0.0).reshape(-1)
        w10 = torch.where(inside, (1 - fx) * fy, 0.0).reshape(-1)
        w11 = torch.where(inside, fx * fy, 0.0).reshape(-1)
        v = (flat[:, (y0i * w + x0i).reshape(-1)] * w00
             + flat[:, (y0i * w + x1i).reshape(-1)] * w01
             + flat[:, (y1i * w + x0i).reshape(-1)] * w10
             + flat[:, (y1i * w + x1i).reshape(-1)] * w11)
        out[a0:a0 + na] = v.reshape(n_rows, na, n_s, n_det).sum(
            dim=2).permute(1, 0, 2)
    return out


def simulate_raw_scan(volume: np.ndarray, geom: ParallelGeometry, *,
                      i0: float = 40000.0, dark_level: float = 96.0,
                      noise: float = 0.0, seed: int = 0,
                      mu: float = 0.02,
                      device: str | torch.device = "cuda"
                      ) -> dict[str, np.ndarray]:
    """Make a realistic uint16 raw scan from a phantom volume:
    transmission I = dark + (I0-dark)·exp(-μ·path) with optional Poisson
    noise; plus dark/flat fields — what a loader plugin would see.

    The projection and the transmission run on ``device``; the random
    numbers are drawn on the host from ``numpy.random.default_rng(seed)``
    in the JAX package's order (flat-field noise, then Poisson), so a
    seed gives the same draws in both packages."""
    dev = resolve_device(device)
    proj = forward_project(volume, geom, dev)           # path lengths
    rng = np.random.default_rng(seed)
    flat = np.full(tuple(proj.shape[1:]), i0, dtype=np.float64)
    flat += rng.normal(0, i0 * 0.002, size=flat.shape)
    dark = np.full(tuple(proj.shape[1:]), dark_level, dtype=np.float64)
    dark_t = torch.as_tensor(dark, device=dev)
    trans = torch.exp(-mu * proj.to(torch.float64))
    counts = dark_t[None] + (torch.as_tensor(flat, device=dev)[None]
                             - dark_t[None]) * trans
    del proj, trans
    if noise > 0:
        host = counts.cpu().numpy()
        counts = rng.poisson(np.clip(host / noise, 0, None)) * noise
        data = np.clip(counts, 0, 65535).astype(np.uint16)
    else:
        # truncating float -> int cast, as numpy's astype does
        data = torch.clamp(counts, 0, 65535).to(torch.int32).cpu().numpy(
            ).astype(np.uint16)
    return {
        "data": data,
        "dark": np.clip(dark, 0, 65535).astype(np.uint16),
        "flat": np.clip(flat, 0, 65535).astype(np.uint16),
        "mu": mu,
        "truth": np.asarray(volume, dtype=np.float32),
    }
