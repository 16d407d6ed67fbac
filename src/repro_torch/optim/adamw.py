"""AdamW (+ global-norm clip, cosine schedule) over dicts of tensors.

Plain functions over ``{name: tensor}`` (a module's ``named_parameters``)
in the reference's arithmetic, op for op: the moments are fp32 whatever
the parameter dtype, weight decay applies to every leaf, and the update
is computed in fp32 and cast back to the parameter's dtype.  The update
runs in place (the port's counterpart of the reference's donated
buffers), one leaf at a time, so its temporaries are one leaf's size.
``torch.optim.AdamW`` is not used: it has no int8 moments and applies
the decay as a separate multiply, which rounds differently in fp32.

``step`` is a 0-d int32 tensor on the parameters' device: it checkpoints
as a leaf and the schedule reads it without a host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    #: 'fp32' or 'int8': blockwise-quantised moments (Dettmers-style
    #: 8-bit Adam), 4 + 4 bytes a parameter -> about 2.06
    moments_dtype: str = "fp32"


def param_dict(params: Any) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _q8(x: torch.Tensor) -> dict:
    """fp32 -> *dynamic* int8 (quadratic map, bnb-style):

        deq = sign(q) · (|q|/127)² · rowmax

    The quadratic code keeps resolution near zero, where linear int8
    would zero small second-moment entries.  q keeps the tensor's shape
    (the scale runs along the last dim); a 0-d tensor becomes (1,).
    ``torch.round`` is half-to-even, as ``jnp.round``."""
    if x.ndim == 0:
        x = x.reshape(1)
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-20)
    norm = torch.clamp(x.abs() / s, 0.0, 1.0)
    q = torch.round(torch.sqrt(norm) * 127.0) * torch.sign(x)
    return {"q": q.to(torch.int8), "s": s}


def _dq8(d: dict, shape: tuple[int, ...]) -> torch.Tensor:
    qf = d["q"].float()
    out = torch.sign(qf) * (qf.abs() / 127.0) ** 2 * d["s"]
    return out.reshape(shape)


def init_opt_state(params: Any, moments_dtype: str = "fp32") -> dict:
    """Zero moments beside each parameter (on its device) and step 0."""
    named = param_dict(params)
    if moments_dtype not in ("fp32", "int8"):
        raise ValueError(f"moments_dtype {moments_dtype!r}: 'fp32' or "
                         f"'int8'")
    if not named:
        raise ValueError("init_opt_state: no parameters")

    def zero(p):
        # zeros_like: a DTensor weight's moments take its placements
        z = torch.zeros_like(p, dtype=torch.float32)
        return _q8(z) if moments_dtype == "int8" else z

    dev = next(iter(named.values())).device
    return {"m": {n: zero(p) for n, p in named.items()},
            "v": {n: zero(p) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return ({n: (g.float() * scale).to(g.dtype) for n, g in tree.items()},
            norm)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any,
                 grads: dict[str, torch.Tensor], state: dict
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, metrics) with metrics ``lr`` and ``grad_norm``, 0-d
    tensors on the device."""
    named = param_dict(params)
    if set(grads) != set(named):
        raise ValueError(f"grads for {sorted(set(grads) ^ set(named))} do "
                         f"not match the parameters")
    state["step"].add_(1)
    step = state["step"]
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    int8 = cfg.moments_dtype == "int8"
    for name, p in named.items():
        g = grads[name]
        gf = (g.float() * clip).to(g.dtype).float()
        m, v = state["m"][name], state["v"][name]
        if int8:
            m = _dq8(m, p.shape)
            v = torch.clamp(_dq8(v, p.shape), min=0.0)
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf * gf
        else:                       # the same arithmetic, in place
            m_new = m.mul_(b1).add_((1 - b1) * gf)
            v_new = v.mul_(b2).add_((1 - b2) * gf * gf)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.float()
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
        if int8:
            state["m"][name], state["v"][name] = _q8(m_new), _q8(v_new)
    return params, state, {"lr": lr, "grad_norm": gnorm}
