"""Raw full-field scans made from the seed, on the device, in closed form.

A scan is what a PCO.edge detector gives Savu: ``data`` (θ, y, x) in
``uint16`` counts, with a dark field and a flat field (y, x) beside it.
It is made from a phantom of ellipses (Shepp–Logan's, jittered by the
seed) whose every row is modulated, so adjacent slices differ:

* the ellipses' Radon transform in closed form, per ellipse, once per
  scan (``K`` × θ × x values), and each row's projection a weighted sum
  of them;
* Beer–Lambert attenuation between the row's dark field (80–120 counts)
  and flat field (30,000–42,000 counts), with a gain error per detector
  column, so that ring removal has rings to remove;
* noise of the counts' own size (a Gaussian stand-in for Poisson),
  rounded and clipped to ``uint16``.

The geometry is the benchmark's own, frozen here: angles
``linspace(0, π, n_angles, endpoint=False)``, the detector's centre at
``(n_det - 1) / 2``, the image's at ``(N - 1) / 2`` with ``N = n_det``,
and a ray at angle θ and detector bin ``j`` the line
``(x - c)·cos θ + (y - c)·sin θ = j - (n_det - 1) / 2``.

Every row is a function of the seed and the row's index in the whole
scan alone (its random numbers come from a generator seeded by both), so
a band of rows reads the same whether it is made alone or with others.
The rows leave the device as host numpy arrays, as a detector's frames
reach Savu.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

#: (value, a, b, x0, y0, phi_deg) in units of the half-width: the
#: modified Shepp–Logan phantom
SHEPP_LOGAN = (
    (1.00, 0.69, 0.92, 0.0, 0.0, 0.0),
    (-0.80, 0.6624, 0.8740, 0.0, -0.0184, 0.0),
    (-0.20, 0.1100, 0.3100, 0.22, 0.0, -18.0),
    (-0.20, 0.1600, 0.4100, -0.22, 0.0, 18.0),
    (0.10, 0.2100, 0.2500, 0.0, 0.35, 0.0),
    (0.10, 0.0460, 0.0460, 0.0, 0.10, 0.0),
    (0.10, 0.0460, 0.0460, 0.0, -0.10, 0.0),
    (0.10, 0.0460, 0.0230, -0.08, -0.605, 0.0),
    (0.10, 0.0230, 0.0230, 0.0, -0.606, 0.0),
    (0.10, 0.0230, 0.0460, 0.06, -0.605, 0.0),
)

#: streams of random numbers drawn from one seed
_PHANTOM, _GAIN, _DARK, _FLAT, _NOISE = range(5)


def angles(n_angles: int) -> np.ndarray:
    """The scan's rotation angles (float64): [0, π), endpoint excluded."""
    return np.linspace(0.0, math.pi, n_angles, endpoint=False)


def _seed(*words: int) -> int:
    """A 63-bit seed from any whole numbers (a seed may exceed 32 bits)."""
    ss = np.random.SeedSequence([int(w) & ((1 << 64) - 1) for w in words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class ScanModel:
    """What defines one seed's scan: the jittered ellipses, each row's
    weights, the column gains, and the attenuation scale.

    ``n_det`` detector columns, ``n_rows`` detector rows (the whole
    detector height), ``n_angles`` projections over 180°; ``scan`` picks
    one of several scans made from one seed."""

    def __init__(self, seed: int, n_det: int, n_rows: int, n_angles: int,
                 params: dict, scan: int = 0):
        self.seed, self.scan = int(seed), int(scan)
        self.n_det, self.n_rows, self.n_angles = n_det, n_rows, n_angles
        self.params = dict(params)
        rng = np.random.default_rng(_seed(seed, scan, _PHANTOM))
        half = n_det / 2.0
        ell = []
        for val, a, b, x0, y0, phi in SHEPP_LOGAN:
            j = rng.uniform(-1.0, 1.0, 5)
            ell.append((val,
                        a * (1 + 0.03 * j[0]) * half,
                        b * (1 + 0.03 * j[1]) * half,
                        (x0 + 0.01 * j[2]) * half,
                        (y0 + 0.01 * j[3]) * half,
                        math.radians(phi + 3.0 * j[4])))
        #: (value, a, b, x0, y0, phi) in pixels and radians
        self.ellipses = tuple(ell)
        # each ellipse's value swings along the rows with its own period
        # and phase, so every slice differs from its neighbours
        self.periods = rng.uniform(0.3, 1.5, len(ell)) * n_rows
        self.phases = rng.uniform(0.0, 2 * math.pi, len(ell))
        grng = np.random.default_rng(_seed(seed, scan, _GAIN))
        self.gain = np.clip(
            1.0 + params["gain_sd"] * grng.standard_normal(n_det),
            0.5, 1.5).astype(np.float32)
        #: attenuation per pixel of path at value 1: the outer ellipse's
        #: longest chord reads ``mu_peak``
        self.mu = float(params["mu_peak"]) / (2 * 0.92 * half)

    def row_weights(self, rows: Sequence[int]) -> np.ndarray:
        """(len(rows), K) float64: each ellipse's value in each row."""
        r = np.asarray(rows, dtype=np.float64)[:, None]
        vals = np.array([e[0] for e in self.ellipses])[None, :]
        swing = 1.0 + 0.15 * np.sin(2 * math.pi * r / self.periods[None, :]
                                    + self.phases[None, :])
        return vals * swing

    def ellipse_projections(self, device: torch.device) -> torch.Tensor:
        """(K, n_angles, n_det) float64: each ellipse's exact line
        integrals (value 1) at every angle and detector bin, in pixels."""
        th = torch.as_tensor(angles(self.n_angles), dtype=torch.float64,
                             device=device)[:, None]
        s = (torch.arange(self.n_det, dtype=torch.float64, device=device)
             - (self.n_det - 1) / 2.0)[None, :]
        out = []
        for _, a, b, x0, y0, phi in self.ellipses:
            a2 = (a * torch.cos(th - phi)) ** 2 + (b * torch.sin(th - phi)) ** 2
            d = s - (x0 * torch.cos(th) + y0 * torch.sin(th))
            out.append(2 * a * b / a2 * torch.sqrt(torch.clamp(a2 - d * d,
                                                               min=0.0)))
        return torch.stack(out)

    def _field(self, rows: Sequence[int], stream: int, lo: float, hi: float,
               gen: torch.Generator, device: torch.device) -> torch.Tensor:
        """(len(rows), n_det) float32, uniform in [lo, hi), row by row."""
        out = torch.empty((len(rows), self.n_det), dtype=torch.float32,
                          device=device)
        for i, r in enumerate(rows):
            gen.manual_seed(_seed(self.seed, self.scan, stream, r))
            out[i].uniform_(lo, hi, generator=gen)
        return out

    def darks_flats(self, rows: Sequence[int], device: torch.device,
                    gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """The dark and flat fields of ``rows``, (len(rows), n_det),
        whole counts as float32."""
        p = self.params
        dark = torch.round(self._field(rows, _DARK, *p["dark_counts"], gen,
                                       device))
        flat = torch.round(self._field(rows, _FLAT, *p["flat_counts"], gen,
                                       device))
        return dark, flat

    def raw(self, rows: Sequence[int], device: torch.device,
            proj: torch.Tensor | None = None) -> dict[str, np.ndarray]:
        """Rows ``rows`` of the scan as host arrays: ``data`` (n_angles,
        len(rows), n_det) uint16, ``dark`` and ``flat`` (len(rows),
        n_det) uint16, ``mu``.  ``proj``: the ellipses' projections
        (:meth:`ellipse_projections`) when the caller makes many bands."""
        rows = [int(r) for r in rows]
        if min(rows) < 0 or max(rows) >= self.n_rows:
            raise ValueError(f"rows {min(rows)}..{max(rows)} outside the "
                             f"scan's {self.n_rows}")
        if proj is None:
            proj = self.ellipse_projections(device)
        gen = torch.Generator(device=device)
        dark, flat = self.darks_flats(rows, device, gen)
        w = torch.as_tensor(self.row_weights(rows), device=device)
        # (θ, rows, x) path integrals, then counts
        path = torch.einsum("rk,kax->arx", w, proj).to(torch.float32)
        gain = torch.as_tensor(self.gain, device=device)
        counts = dark[None] + (flat - dark)[None] * gain * torch.exp(
            -self.mu * path)
        del path
        noise = torch.empty((self.n_angles, self.n_det), dtype=torch.float32,
                            device=device)
        for i, r in enumerate(rows):
            gen.manual_seed(_seed(self.seed, self.scan, _NOISE, r))
            noise.normal_(generator=gen)
            c = counts[:, i]
            c += torch.sqrt(torch.clamp(c, min=0.0)) * noise
        data = _host_u16(torch.clamp(torch.round(counts), 0, 65535))
        del counts
        return {"data": data, "dark": _host_u16(dark),
                "flat": _host_u16(flat),
                "mu": self.mu}

    def truth(self, row: int, size: int | None = None) -> np.ndarray:
        """The phantom's slice ``row`` as attenuation per pixel (the
        value that a reconstruction divided by ``mu`` estimates), (N, N)
        float64, sampled at pixel centres."""
        n = size or self.n_det
        c = (n - 1) / 2.0
        yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) - c
        img = np.zeros((n, n))
        for (_, a, b, x0, y0, phi), v in zip(self.ellipses,
                                             self.row_weights([row])[0]):
            xr = (xx - x0) * math.cos(phi) + (yy - y0) * math.sin(phi)
            yr = -(xx - x0) * math.sin(phi) + (yy - y0) * math.cos(phi)
            img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
        return img


def _host_u16(t: torch.Tensor) -> np.ndarray:
    """Whole counts 0..65535 (float) as a host uint16 array, moved as
    two bytes a value: shifted into int16 on the device, shifted back
    on the host (``x - 32768`` as int16 has ``x``'s bits with the top
    one flipped).  The array is C-contiguous, as a detector's frames
    are."""
    host = (t - 32768).to(torch.int16).contiguous().cpu().numpy().view(
        np.uint16)
    np.bitwise_xor(host, np.uint16(0x8000), out=host)
    return host


def whole(model: ScanModel, device: torch.device, block: int = 16
          ) -> dict[str, np.ndarray]:
    """Every row of the scan, made ``block`` rows at a time into one host
    array (n_angles, n_rows, n_det) uint16."""
    proj = model.ellipse_projections(device)
    data = np.empty((model.n_angles, model.n_rows, model.n_det), np.uint16)
    dark = np.empty((model.n_rows, model.n_det), np.uint16)
    flat = np.empty_like(dark)
    for r0 in range(0, model.n_rows, block):
        rows = range(r0, min(r0 + block, model.n_rows))
        part = model.raw(rows, device, proj)
        data[:, r0:r0 + len(rows)] = part["data"]
        dark[r0:r0 + len(rows)] = part["dark"]
        flat[r0:r0 + len(rows)] = part["flat"]
    return {"data": data, "dark": dark, "flat": flat, "mu": model.mu}
