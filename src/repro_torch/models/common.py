"""Model configuration + parameter-initialisation utilities."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # rope
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # chatglm-style partial rotary
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 0             # every k-th layer is MoE (0 = none)
    moe_grouped: bool = False
    # ssm / recurrent
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    slstm_every: int = 0           # xlstm: every k-th layer is sLSTM
    attn_every: int = 0            # zamba: shared attn after every k layers
    # enc-dec
    n_enc_layers: int = 0
    # vlm / audio stubs
    frontend: str = ""             # 'patch' | 'mel' | ''
    max_frames: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16    # activation/weight compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True             # checkpoint each layer when training
    remat_policy: str = "dots"     # 'dots' | 'nothing' (models/remat.py)
    seq_shard_fallback: bool = False
    use_flash: bool = False        # the hand-written attention kernel
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters (for 6ND model-flops accounting)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        if self.is_moe:
            every = max(1, self.moe_every)
            n_moe = self.n_layers // every
            n_dense = self.n_layers - n_moe
            moe_ffw = (self.n_experts * 3 * d * self.moe_d_ff +
                       self.n_experts * d +
                       self.n_shared_experts * 3 * d * self.moe_d_ff)
            ffw_total = n_moe * moe_ffw + n_dense * 3 * d * self.d_ff
        else:
            ffw_total = self.n_layers * 3 * d * self.d_ff
        norm = 2 * d
        per_layer = attn + norm
        total = emb + self.n_layers * per_layer + ffw_total
        if self.family == "encdec":
            total += self.n_enc_layers * per_layer + self.n_layers * \
                (d * hd * (self.n_heads + 2 * self.n_kv_heads) +
                 self.n_heads * hd * d)  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        every = max(1, self.moe_every)
        n_moe = self.n_layers // every
        all_expert = n_moe * self.n_experts * 3 * d * self.moe_d_ff
        active_expert = n_moe * max(1, self.top_k) * 3 * d * self.moe_d_ff
        return int(self.param_count() - all_expert + active_expert)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A weight of an evaluation-only module: no gradient is tracked."""
    return nn.Parameter(t, requires_grad=False)


def trainable(module: nn.Module) -> nn.Module:
    """``module`` as a trainer holds it: every weight tracks its gradient.
    A trainer also stores its weights in ``cfg.param_dtype`` (see
    :func:`training_storage`), so an update is never rounded to the
    compute dtype."""
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def training_storage(cfg: ModelConfig) -> ModelConfig:
    """The config an init stores a trainer's weights with: every weight
    in ``cfg.param_dtype``, as the reference keeps them.  The forward
    casts each weight to ``cfg.dtype`` at its use whatever it is stored
    in, so fp32-stored weights compute what bf16-stored ones do."""
    return dataclasses.replace(cfg, dtype=cfg.param_dtype)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def truncated_normal(generator: torch.Generator, shape, std: float,
                     dtype) -> torch.Tensor:
    """Normal(0, std) truncated to ±2 std, drawn on the generator's device
    by inverting the CDF of uniform samples, then stored in ``dtype``."""
    lo, hi = _norm_cdf(-2.0), _norm_cdf(2.0)
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return t.to(dtype)


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: tuple[int, ...], dtype) -> torch.Tensor:
    std = 1.0 / math.sqrt(in_dim)
    return truncated_normal(generator, out_shape, std, dtype)
