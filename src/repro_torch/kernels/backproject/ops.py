"""Public op for backprojection: the CUDA gather kernel (all slices in
one launch) on a CUDA tensor; the plain PyTorch version on a CPU tensor
or when asked for it."""
from __future__ import annotations

import torch

from .. import tally
from .kernel import backproject_cuda, cost, rays_on_detector
from .ref import backproject_ref


def backproject(sino: torch.Tensor, angles: torch.Tensor, out_size: int,
                centre: float | None = None, *,
                use_pallas: bool = True) -> torch.Tensor:
    """Filtered-backproject sinogram(s) -> image(s).

    sino: (..., n_angles, n_det); returns (..., out_size, out_size).
    ``use_pallas`` asks for the hand-written kernel (the JAX package's
    parameter name); a CUDA tensor with ``use_pallas=True`` launches it
    or raises.
    """
    lead = sino.shape[:-2]
    n_angles, n_det = sino.shape[-2:]
    if not use_pallas or sino.device.type == "cpu":
        theta = angles.to(sino.device, torch.float32)
        with tally.plain_version("backprojection", lambda: cost(
                sino.numel() // max(n_angles * n_det, 1), n_angles, n_det,
                out_size, rays_on_detector(torch.cos(theta),
                                           torch.sin(theta), out_size,
                                           n_det, centre))):
            return backproject_ref(sino, angles, out_size, centre)
    flat = sino.to(torch.float32).reshape((-1, n_angles, n_det)).contiguous()
    # float32 tables, as the reference computes them
    theta = angles.to(sino.device, torch.float32)
    out = backproject_cuda(flat, torch.cos(theta).contiguous(),
                           torch.sin(theta).contiguous(), out_size, centre)
    return out.reshape(lead + (out_size, out_size))
