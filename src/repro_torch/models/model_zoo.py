"""Unified model API: build_model(cfg) -> Model with init / loss /
forward / prefill / decode_step / init_cache.

The port has the dense family; the others raise until their ROADMAP
item lands.  ``forward`` and ``loss`` evaluate (no train step yet).

Batch convention: {tokens (B,S), labels (B,S)}, numpy arrays or
tensors; labels < 0 are ignored (masked out of the CE mean).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import resolve_device
from .attention import init_cache as init_kv_cache
from .common import ModelConfig
from .transformer import (LM, MOE_TODO, init_lm, lm_decode_step, lm_forward,
                          lm_prefill)

AUX_WEIGHT = 0.01

#: families of the reference still to port, with their ROADMAP item
NOT_PORTED = {
    "moe": MOE_TODO,
    "vlm": "ROADMAP.md queue 1, item 9: VLM prefill (patch embeddings)",
    "ssm": "ROADMAP.md queue 1, item 9: xLSTM (models/xlstm*.py)",
    "hybrid": "ROADMAP.md queue 1, item 9: Zamba2 (models/zamba.py, "
              "mamba2.py, ssd.py)",
    "encdec": "ROADMAP.md queue 1, item 9: Whisper (models/whisper.py)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], LM]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    loss: Callable[[LM, dict], torch.Tensor]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[[LM, torch.Tensor, Any], tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over positions with label >= 0.  logits fp32 (B,S,V)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / mask.sum().clamp_min(1)


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                ) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU; raises when the card is asked for and absent)."""
    dev = resolve_device(device)
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} is "
                                  f"not ported yet ({NOT_PORTED[cfg.family]})")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    def init(generator: torch.Generator) -> LM:
        if generator.device.type != dev.type:
            raise ValueError(f"init: generator on {generator.device}, "
                             f"model on {dev}")
        return init_lm(generator, cfg)

    def forward(params: LM, batch: dict):
        return lm_forward(params, cfg, tokens=tensor(batch["tokens"]))

    def loss(params: LM, batch: dict) -> torch.Tensor:
        logits, aux = forward(params, batch)
        return cross_entropy(logits, tensor(batch["labels"])) + \
            AUX_WEIGHT * aux

    def prefill(params: LM, batch: dict, max_len: int):
        return lm_prefill(params, cfg, tensor(batch["tokens"]), max_len)

    def decode_step(params: LM, token, cache: dict):
        return lm_decode_step(params, cfg, tensor(token), cache)

    def init_cache(batch_size: int, max_len: int) -> dict:
        kv = init_kv_cache(cfg, batch_size, max_len, device=dev)
        return {"k": kv.k, "v": kv.v, "length": kv.length}

    return Model(cfg, dev, init, forward, loss, prefill, decode_step,
                 init_cache)
