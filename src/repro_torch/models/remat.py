"""Rematerialisation of a layer in training (``cfg.remat``,
``cfg.remat_policy``), through ``torch.utils.checkpoint`` (non-reentrant).

'dots'    — the reference's ``dots_with_no_batch_dims_saveable``: the
            outputs of products without batch dims are saved (the q/k/v
            and output projections, the FFN's up/gate/down, the MoE
            router, the recurrent blocks' projections); everything else,
            the attention's and the experts' batched products included,
            is recomputed in the backward.  The faster backward, the
            larger activation memory.
'nothing' — only the layer's input is saved; the whole layer runs again
            in the backward: more compute, the smallest footprint.

Every einsum of the port reaches ``aten.bmm``, so the op's name does not
tell the two kinds apart: a product without batch dims
(``"bsd,dhk->bshk"``, ``"...d,df->...f"``) reaches it with a batch of 1,
the attention's ``"bhqd,bhkd->bhqk"`` with a batch of B·H and the experts'
``torch.bmm`` with a batch of E.  The ops saved under 'dots' are
therefore ``aten.mm`` and ``aten.addmm`` (2-D operands: no batch dims)
and ``aten.bmm`` whose first operand has a batch of 1.  A batched product
whose batch happens to be 1 (B·H = 1) is saved too.

Remat applies only while grad is enabled, so serving runs the layer as
it is.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .common import ModelConfig

_aten = torch.ops.aten
_UNBATCHED = (_aten.mm.default, _aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _UNBATCHED or (op == _aten.bmm.default and
                            args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (one layer or group of layers) wrapped in the checkpoint that
    ``cfg`` asks for while grad is enabled; ``fn`` itself otherwise."""
    if cfg.remat_policy not in ("dots", "nothing"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'dots' or "
                         f"'nothing'")
    if not cfg.remat:
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat_policy == "nothing":
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)

    return wrapped
