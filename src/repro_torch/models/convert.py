"""Load the JAX package's LM parameters into the port's modules.

``params`` is the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed``, an optional
``unembed``, ``ln_f``, and ``layers`` — a sequence with one dict per
sub-layer kind of a group, each leaf stacked over the groups on its
leading axis.  Every weight keeps its shape (``wq`` (d, H, hd), ``wo``
(H, hd, d), ...), so no transpose can go wrong.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .attention import Attention
from .common import ModelConfig
from .mlp import MLP
from .transformer import LM, Block, dense_groups


def params_from_jax(params: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> LM:
    """The port's LM holding ``params``: tables in ``cfg.param_dtype``,
    block weights and norm scales in ``cfg.dtype``."""
    dev = resolve_device(device)
    n_groups, kinds = dense_groups(cfg)
    subs = list(params["layers"])
    if len(subs) != len(kinds):
        raise ValueError(f"{len(subs)} sub-layer kinds in the tree, "
                         f"{cfg.arch_id} has {len(kinds)}")
    if ("unembed" in params) == cfg.tie_embeddings:
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'unembed' in params else 'lacks'} "
                         f"an unembed table")

    def tensor(a, dtype=cfg.dtype) -> torch.Tensor:
        # float32 first: numpy's bfloat16 is not a torch dtype; exact
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(dev, dtype)

    layers = []
    for g in range(n_groups):
        for sub in subs:
            if sub["ln1"].shape[0] != n_groups:
                raise ValueError(f"layers stacked {sub['ln1'].shape[0]} "
                                 f"deep, {cfg.arch_id} has {n_groups} groups")
            attn, mlp = sub["attn"], sub["mlp"]
            layers.append(Block(
                tensor(sub["ln1"][g]),
                Attention(*(tensor(attn[n][g])
                            for n in ("wq", "wk", "wv", "wo"))),
                tensor(sub["ln2"][g]),
                MLP(tensor(mlp["w_up"][g]), tensor(mlp["w_down"][g]),
                    tensor(mlp["w_gate"][g]) if "w_gate" in mlp else None)))
    out = params.get("unembed")
    return LM(tensor(params["embed"], cfg.param_dtype), layers,
              tensor(params["ln_f"]),
              None if out is None else tensor(out, cfg.param_dtype))
