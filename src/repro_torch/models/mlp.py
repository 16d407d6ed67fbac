"""Feed-forward blocks: SwiGLU (llama-family default) and GELU."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, frozen
from .sharding import get_rules


class MLP(nn.Module):
    """w_up (d, f), w_down (f, d) and, for SwiGLU, w_gate (d, f)."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: torch.Tensor | None = None):
        super().__init__()
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        self.w_gate = None if w_gate is None else frozen(w_gate)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True) -> MLP:
    """Weights drawn in fp32 and stored in ``dtype``."""
    w_up = dense_init(generator, d_model, (d_model, d_ff), dtype)
    w_down = dense_init(generator, d_ff, (d_ff, d_model), dtype)
    w_gate = (dense_init(generator, d_model, (d_model, d_ff), dtype)
              if gated else None)
    return MLP(w_up, w_down, w_gate)


def mlp_fwd(params: MLP, x: torch.Tensor, dtype, activation: str = "silu"
            ) -> torch.Tensor:
    """x (..., d) -> (..., d); SwiGLU when w_gate present, else GELU."""
    r = get_rules()
    lead = ("batch", "seq") if x.ndim == 3 else ("batch",) * (x.ndim - 1)
    # the sequence-parallel residual is gathered before the block
    x = r.constrain(x, *lead, "embed_act")
    up = torch.einsum("...d,df->...f", x, params.w_up.to(dtype))
    up = r.constrain(up, *lead, "ffn_act")
    if params.w_gate is not None:
        gate = torch.einsum("...d,df->...f", x, params.w_gate.to(dtype))
        act = F.silu(gate.float()).to(dtype) * up
    elif activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        act = F.gelu(up.float(), approximate="tanh").to(dtype)
    else:
        act = F.silu(up.float()).to(dtype)
    out = torch.einsum("...f,fd->...d", act, params.w_down.to(dtype))
    return r.constrain(out, *lead, "embed_act")
