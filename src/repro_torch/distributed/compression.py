"""Gradient compression for cross-pod data parallelism.

int8 block-quantised all-reduce with error feedback: the inter-pod link
is the slow one, so the pod-boundary gradient reduction is the place
compression pays.  The intra-pod reduction stays full-precision; only
the ``pod`` axis uses the quantised path.

``compressed_psum`` runs ``torch.distributed`` collectives on the mesh's
``pod`` group: an all-reduce(MAX) of the per-block maxima, so every
participant quantises with one shared scale, then an int32
all-reduce(SUM) of the int8 codes.  Error feedback keeps the
quantisation noise unbiased over steps (residual carried in fp32).  The
arithmetic is the reference's op for op: ``torch.round`` rounds half to
even as ``jnp.round`` does, and the scale is the block max / 127.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened fp32, zero-padded to whole blocks: (n_blocks, BLOCK)."""
    flat = x.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)


def _scale(block_max: torch.Tensor) -> torch.Tensor:
    """max / 127, at least 1e-12.  The divisor is a tensor on the
    operand's device: a Python scalar divisor takes the reciprocal's
    product on the card, one rounding away from the division."""
    return torch.clamp(block_max / torch.full_like(block_max, 127.0),
                       min=1e-12)


def _codes(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127
                       ).to(torch.int8)


def quantise_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8.  x -> (q int8 (n_blocks, BLOCK), scales
    fp32 (n_blocks, 1))."""
    blocks = _blocks(x)
    scale = _scale(blocks.abs().amax(dim=1, keepdim=True))
    return _codes(blocks, scale), scale


def dequantise_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    shape: tuple[int, ...]) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return x.reshape(shape)


def quantise_tree(grads: dict[str, torch.Tensor] | nn.Module,
                  residual: dict[str, torch.Tensor] | None = None
                  ) -> tuple[dict, dict, dict]:
    """Quantise every leaf with error feedback.

    ``grads``: ``{name: tensor}``, or a module, whose parameters' ``.grad``
    are taken.  Returns (quantised leaves (q, scale), dequantised grads,
    new residual), each by name.  Callers all-reduce the dequantised
    grads (simulating the int8 wire format; on a real link the int8
    payload is what moves)."""
    if isinstance(grads, nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()
                 if p.grad is not None}
    if residual is None:
        residual = {n: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for n, g in grads.items()}
    qs, deq, res = {}, {}, {}
    for n, g in grads.items():
        gf = g.to(torch.float32) + residual[n]
        q, s = quantise_int8(gf)
        d = dequantise_int8(q, s, gf.numel(), tuple(gf.shape))
        qs[n], deq[n], res[n] = (q, s), d, gf - d
    return qs, deq, res


def compressed_psum(x: torch.Tensor, mesh: Any, axis: str = "pod"
                    ) -> torch.Tensor:
    """int8-quantise → sum over ``axis`` of ``mesh`` (a ``DeviceMesh``)
    → dequantise, in ``x``'s dtype.  Payload on the wire is (int8 q, fp32
    scales) ≈ 4× smaller than fp32; the codes are summed in int32.  The
    identity when the mesh has no such axis."""
    if axis not in (mesh.mesh_dim_names or ()):
        return x
    group = mesh.get_group(axis)
    blocks = _blocks(x)
    # agree on a shared per-block scale: max over the axis's participants
    # (a small fp32 all-reduce, n / BLOCK values on the wire)
    gmax = blocks.abs().amax(dim=1, keepdim=True)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(gmax)
    qsum = _codes(blocks, scale).to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    out = (qsum.to(torch.float32) * scale).reshape(-1)[:x.numel()]
    return out.reshape(x.shape).to(x.dtype)
