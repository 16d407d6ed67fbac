"""Training step factory: loss -> grad -> clip -> AdamW, with optional
microbatched gradient accumulation.

The step runs eagerly on the parameters' device.  Gradients come from
``.backward()`` into each weight's ``.grad`` (fp32, since a trainer
stores its weights in ``cfg.param_dtype``); the update then runs in
place under ``torch.no_grad()``, the port's counterpart of the
reference's donated buffers.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ..models.model_zoo import Model
from ..optim import AdamWConfig, adamw_update, init_opt_state


def _split(batch: dict, n: int) -> list[dict]:
    """``batch`` cut on dim 0 into ``n`` equal chunks, in order."""
    chunks = []
    for i in range(n):
        chunk = {}
        for k, x in batch.items():
            b = len(x)
            if b % n:
                raise ValueError(f"batch[{k!r}] has {b} rows, not a "
                                 f"multiple of microbatch {n}")
            chunk[k] = x[i * (b // n):(i + 1) * (b // n)]
        chunks.append(chunk)
    return chunks


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatch: int | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` and ``opt_state`` are updated in place and
    returned.  ``metrics`` holds ``loss``, ``lr`` and ``grad_norm``, 0-d
    tensors on the device (reading one waits for the step).

    ``microbatch``: split the (global) batch into this many sequential
    accumulation chunks: the loss is the mean of the chunks' losses and
    the gradient the mean of theirs, accumulated in fp32, as the
    reference's scan computes them.  ``batch`` may also come as the list
    of its ``microbatch`` chunks, already split (the dry-run places each
    chunk over the data axis, which a slice of a placed batch is not).
    """

    def train_step(params: nn.Module, opt_state: dict, batch: dict):
        named = dict(params.named_parameters())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(
                f"{len(frozen)} weights do not track gradients (first "
                f"{frozen[0]!r}): build them with build_model(cfg, "
                f"training=True) or params_from_jax(..., for_training=True)")
        for p in named.values():
            p.grad = None
        n = microbatch if microbatch and microbatch > 1 else 1
        if isinstance(batch, list):
            if len(batch) != n:
                raise ValueError(f"{len(batch)} chunks for microbatch {n}")
            chunks = batch
        else:
            chunks = _split(batch, n) if n > 1 else [batch]
        loss = None
        for chunk in chunks:
            l = model.loss(params, chunk)
            l.backward()
            l = l.detach()
            loss = l if loss is None else loss + l
        grads = {}
        with torch.no_grad():
            for name, p in named.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads[name] = g.mul_(1.0 / n) if n > 1 else g
                p.grad = None
        if n > 1:
            loss = loss * (1.0 / n)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def init_training(model: Model, generator: torch.Generator, *,
                  moments_dtype: str = "fp32") -> tuple[nn.Module, dict]:
    """A trainer's weights from ``generator`` (on the model's device) and
    zero optimizer state beside them."""
    if not model.training:
        raise ValueError("init_training: build the model with "
                         "build_model(cfg, training=True)")
    params = model.init(generator)
    return params, init_opt_state(params, moments_dtype)
