"""Unified model API: build_model(cfg) -> Model with init / loss /
forward / prefill / decode_step / init_cache, dispatching on family.
``build_model(cfg, training=True)`` makes ``init`` return a trainer's
weights: stored in ``cfg.param_dtype`` and tracking their gradients
(``training/train_step.py`` differentiates ``loss``); the forward is the
same either way.

Batch conventions (numpy arrays or tensors):
  dense/moe/ssm/hybrid : {tokens (B,S), labels (B,S)}
  vlm                  : {tokens (B,S_text), patches (B,S_patch,d),
                          labels (B,S_text+S_patch)}  (patches first)
  encdec               : {frames (B,T,d), tokens (B,S), labels (B,S)}

Labels < 0 are ignored (masked out of the CE mean).

The recurrent families (ssm, hybrid) prefill as the reference does: the
forward's last logits and a *zero* cache, so decoding starts from an
empty state at position 0 whatever the prompt was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from ..device import resolve_device
from .attention import init_cache as init_kv_cache
from .common import ModelConfig, trainable, training_storage
from .layers import embed_tokens
from .sharding import get_rules
from .transformer import (init_lm, lm_decode_step, lm_forward, lm_prefill,
                          lm_prefill_embeds)
from .whisper import (init_whisper, init_whisper_cache, whisper_decode_step,
                      whisper_forward, whisper_prefill)
from .xlstm_model import (init_xlstm, init_xlstm_cache, xlstm_decode_step,
                          xlstm_forward)
from .zamba import (init_zamba, init_zamba_cache, zamba_decode_step,
                    zamba_forward)

AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], nn.Module]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    loss: Callable[[nn.Module, dict], torch.Tensor]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[[nn.Module, torch.Tensor, Any],
                          tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]
    training: bool = False


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over positions with label >= 0.  logits fp32 (B,S,V).

    Written as reductions over the vocab (max, sum of exps, the label's
    logit picked by a mask) so that logits split over the vocab (the
    dry-run's DTensors) reduce shard by shard; the max is held constant
    in the backward, as ``logsumexp``'s is."""
    r = get_rules()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    m = logits.amax(-1, keepdim=True).detach()
    logz = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
            )[..., 0]
    vocab = r.place(torch.arange(logits.shape[-1], device=logits.device),
                    "vocab_act")
    gold = torch.where(vocab == safe[..., None], logits, 0.0).sum(-1)
    ce = (logz - gold) * mask
    return ce.sum() / mask.sum().clamp_min(1)


def _vlm_embeds(params, cfg: ModelConfig, tokens, patches):
    tok = embed_tokens(params.embed, tokens, cfg.dtype)
    return torch.cat([patches.to(cfg.dtype), tok], dim=1)


#: each family's (init, forward, decode_step) on (params, cfg, ...)
_RECURRENT = {
    "ssm": (init_xlstm, xlstm_forward, xlstm_decode_step),
    "hybrid": (init_zamba, zamba_forward, zamba_decode_step),
}


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda", *,
                training: bool = False) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU; raises when the card is asked for and absent).
    With ``training``, ``init`` stores every weight in ``cfg.param_dtype``
    and sets ``requires_grad``."""
    dev = resolve_device(device)
    fam = cfg.family
    if fam not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {fam!r}")

    def tensor(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor) and a.device.type == dev.type:
            return a                    # a DTensor of the dry-run too
        return torch.as_tensor(a, device=dev)

    def on_device(fn):
        def init(generator: torch.Generator) -> nn.Module:
            if generator.device.type != dev.type:
                raise ValueError(f"init: generator on {generator.device}, "
                                 f"model on {dev}")
            if training:
                return trainable(fn(generator, training_storage(cfg)))
            return fn(generator, cfg)
        return init

    def loss_of(forward, aux_weight):
        def loss(params, batch: dict) -> torch.Tensor:
            logits, aux = forward(params, batch)
            ce = cross_entropy(logits, tensor(batch["labels"]))
            return ce + aux_weight * aux if aux_weight else ce
        return loss

    if fam in ("dense", "moe", "vlm"):
        def forward(params, batch: dict):
            if fam == "vlm" and "patches" in batch:
                return lm_forward(params, cfg, embeds=_vlm_embeds(
                    params, cfg, tensor(batch["tokens"]),
                    tensor(batch["patches"])))
            return lm_forward(params, cfg, tokens=tensor(batch["tokens"]))

        def prefill(params, batch: dict, max_len: int):
            if fam == "vlm" and "patches" in batch:
                # the patch prefix is part of the prompt
                return lm_prefill_embeds(params, cfg, _vlm_embeds(
                    params, cfg, tensor(batch["tokens"]),
                    tensor(batch["patches"])), max_len)
            return lm_prefill(params, cfg, tensor(batch["tokens"]), max_len)

        def decode_step(params, token, cache: dict):
            return lm_decode_step(params, cfg, tensor(token), cache)

        def init_cache(batch_size: int, max_len: int) -> dict:
            kv = init_kv_cache(cfg, batch_size, max_len, device=dev)
            return {"k": kv.k, "v": kv.v, "length": kv.length}

        return Model(cfg, dev, on_device(init_lm), forward,
                     loss_of(forward, AUX_WEIGHT), prefill, decode_step,
                     init_cache, training)

    if fam in _RECURRENT:       # xLSTM, Zamba2
        init_fn, forward_fn, decode_fn = _RECURRENT[fam]

        def init_cache(batch_size: int, max_len: int) -> dict:
            if fam == "ssm":
                return init_xlstm_cache(cfg, batch_size, device=dev)
            return init_zamba_cache(cfg, batch_size, max_len, device=dev)

        def forward(params, batch: dict):
            return forward_fn(params, cfg, tokens=tensor(batch["tokens"]))

        def prefill(params, batch: dict, max_len: int):
            logits, _ = forward(params, batch)
            return logits[:, -1:, :], init_cache(len(batch["tokens"]),
                                                 max_len)

        def decode_step(params, token, cache: dict):
            return decode_fn(params, cfg, tensor(token), cache)

        return Model(cfg, dev, on_device(init_fn), forward,
                     loss_of(forward, 0.0), prefill, decode_step, init_cache,
                     training)

    # encdec: Whisper
    def frames(batch: dict) -> torch.Tensor:
        if "frames" not in batch:
            raise ValueError(
                f"{cfg.arch_id}: the encoder-decoder family needs 'frames' "
                f"(B, T, d) beside 'tokens'; ContinuousBatcher's requests "
                f"carry tokens only, so serve it with greedy_generate and a "
                f"batch that holds the frames")
        return tensor(batch["frames"])

    def forward(params, batch: dict):
        return whisper_forward(params, cfg, frames=frames(batch),
                               tokens=tensor(batch["tokens"]))

    def prefill(params, batch: dict, max_len: int):
        return whisper_prefill(params, cfg, frames(batch),
                               tensor(batch["tokens"]), max_len)

    def decode_step(params, token, cache: dict):
        return whisper_decode_step(params, cfg, tensor(token), cache)

    def init_cache(batch_size: int, max_len: int) -> dict:
        return init_whisper_cache(cfg, batch_size, max_len, device=dev)

    return Model(cfg, dev, on_device(init_whisper), forward,
                 loss_of(forward, 0.0), prefill, decode_step, init_cache,
                 training)
