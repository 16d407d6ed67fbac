"""The plain reference of the phase-contrast chain, in PyTorch: dark/flat
correction, Paganin's phase retrieval over whole projections, then ring
removal, the ramp filter and backprojection of chosen rows.

Paganin's filter couples the rows of a projection (its kernel decays
over ``sqrt(tau) / 2π`` pixels), so the reference retrieves every
projection whole, a block of angles at a time, and keeps only the
chosen rows of each; from there on every slice is independent, and
the stages are :mod:`tomobench.reference.chain`'s.

Retrieval, as the configuration states it: each corrected projection
``p`` (rows × columns) back to transmission ``exp(-p)``, ``pad_y`` rows
and ``pad_x`` columns repeated from its edges, its 2-D discrete Fourier
transform scaled by ``1 / (1 + tau·(ky² + kx²))`` with the frequencies
of the padded lengths in cycles per pixel, the inverse transform's real
part cropped back, and ``−log(max(·, 1e-6))``.

``mode`` is :mod:`~tomobench.reference.chain`'s: ``"fp32"`` the
reference; ``"bf16"`` (the control) keeps every value of the data path
in bfloat16 (torch.fft has no bfloat16: the transform's values are
bfloat16 before and after it); ``"bf16_storage"`` rounds each stage's
output to bfloat16 and computes in float32.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import chain

#: projections retrieved at a time
ANGLES = 64


def chain_params(process_list: Sequence[dict]) -> dict:
    """:func:`chain.chain_params` and the Paganin step's ``tau``,
    ``pad_y`` and ``pad_x``."""
    by = {e["plugin"]: e.get("params", {}) for e in process_list}
    pag = by["paganin_filter"]
    return {**chain.chain_params(process_list),
            "paganin": (float(pag.get("tau", 10.0)),
                        int(pag.get("pad_y", 0)), int(pag.get("pad_x", 0)))}


def denominator(ny: int, nx: int, tau: float,
                device: torch.device) -> torch.Tensor:
    """``1 / (1 + tau·(ky² + kx²))`` over an ``ny`` × ``nx`` spectrum
    (computed in float64, kept as complex64)."""
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.fftfreq(nx)[None, :]
    return torch.as_tensor((1.0 / (1.0 + tau * (ky ** 2 + kx ** 2)))
                           .astype(np.complex64), device=device)


def retrieve(proj: torch.Tensor, tau: float, pad_y: int, pad_x: int,
             mode: str = "fp32", denom: torch.Tensor | None = None
             ) -> torch.Tensor:
    """(A, Y, X) corrected projections -> retrieved, the same shape."""
    dt = chain._dt(mode)
    x = torch.exp(-proj.to(dt))
    if pad_y or pad_x:
        x = F.pad(x, (pad_x, pad_x, pad_y, pad_y), mode="replicate")
    ny, nx = x.shape[-2:]
    if denom is None:
        denom = denominator(ny, nx, tau, proj.device)
    spec = torch.fft.fft2(x.to(torch.complex64), dim=(-2, -1))
    del x
    filt = torch.fft.ifft2(spec * denom, dim=(-2, -1)).real
    del spec
    filt = filt[:, pad_y:ny - pad_y, pad_x:nx - pad_x].to(dt)
    return chain._store(-torch.log(torch.clamp(filt, min=1e-6)), mode)


def reconstruct(scan: dict, rows: Sequence[int], params: dict,
                device: torch.device, mode: str = "fp32",
                cutoff: float | None = None, block: int = ANGLES
                ) -> torch.Tensor:
    """Rows ``rows`` (indices into ``scan["data"]``'s y axis) of the
    scan reconstructed through the Paganin chain: (len(rows), N, N)
    float32 on ``device``.  Every projection is corrected and retrieved
    whole, ``block`` angles at a time.  ``cutoff`` overrides the
    filter's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    idx = list(rows)
    data = scan["data"]
    n_ang, n_rows, n_det = data.shape
    tau, pad_y, pad_x = params["paganin"]
    dark = torch.as_tensor(scan["dark"].astype(np.float32),
                           device=device)[None]
    flat = torch.as_tensor(scan["flat"].astype(np.float32),
                           device=device)[None]
    denom = denominator(n_rows + 2 * pad_y, n_det + 2 * pad_x, tau, device)
    sino = None
    for a0 in range(0, n_ang, block):
        raw = torch.as_tensor(np.ascontiguousarray(data[a0:a0 + block]),
                              device=device)
        proj = retrieve(chain.correct(raw, dark, flat, mode), tau, pad_y,
                        pad_x, mode, denom)
        del raw
        part = proj[:, idx].transpose(0, 1)            # (S, a, X)
        if sino is None:
            sino = torch.empty((len(idx), n_ang, n_det), dtype=part.dtype,
                               device=device)
        sino[:, a0:a0 + part.shape[1]] = part
        del proj, part
    if params["ring"] is not None:
        sino = chain.ring_removal(sino, *params["ring"], mode=mode)
    sino = chain.sino_filter(sino, params["kind"],
                             params["cutoff"] if cutoff is None else cutoff,
                             mode)
    return chain.backproject(sino, params["out_size"] or n_det,
                             float(scan.get("mu", 1.0)), mode)
