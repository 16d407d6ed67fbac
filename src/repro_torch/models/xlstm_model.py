"""xLSTM LM assembly: groups of (slstm_every−1) mLSTM + 1 sLSTM blocks
(the released 7:1 recipe).

The cache keeps the reference's layout (``mlstm``: an ``MLSTMCache`` of
(G, m, B, ...) tensors, or (G, B, ...) with no sLSTM; ``slstm``: an
``SLSTMCache`` of (G, B, ...) tensors), and decode writes it in place.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import ModelConfig, frozen
from .layers import embed_tokens, init_embedding, rms_norm, unembed
from .remat import remat
from .xlstm import (MLSTMBlock, MLSTMCache, SLSTMBlock, SLSTMCache,
                    init_mlstm_block, init_mlstm_cache, init_slstm_block,
                    init_slstm_cache, mlstm_fwd, mlstm_step, slstm_fwd,
                    slstm_step)
from .sharding import get_rules, sp_residual


def _layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, mlstm_per_group). slstm_every==0 -> pure mLSTM."""
    if cfg.slstm_every == 0:
        return cfg.n_layers, 0
    assert cfg.n_layers % cfg.slstm_every == 0
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


class XLSTM(nn.Module):
    """embed, ln_f, mlstm (G lists of m blocks; G blocks when there is no
    sLSTM), slstm (G blocks, or none), unembed (None when tied)."""

    def __init__(self, embed, ln_f, mlstm: list, slstm: list[SLSTMBlock],
                 unembed=None):
        super().__init__()
        self.embed = frozen(embed)
        self.ln_f = frozen(ln_f)
        self.mlstm = nn.ModuleList(
            m if isinstance(m, MLSTMBlock) else nn.ModuleList(m)
            for m in mlstm)
        self.slstm = nn.ModuleList(slstm)
        self.unembed = None if unembed is None else frozen(unembed)

    @property
    def out_table(self) -> torch.Tensor:
        return self.embed if self.unembed is None else self.unembed


def init_xlstm(generator: torch.Generator, cfg: ModelConfig) -> XLSTM:
    """Random weights on the generator's device, drawn in fp32."""
    g, m = _layout(cfg)
    dev = generator.device
    embed = init_embedding(generator, cfg)
    if cfg.slstm_every == 0:
        mlstm = [init_mlstm_block(generator, cfg) for _ in range(g)]
        slstm = []
    else:
        mlstm = [[init_mlstm_block(generator, cfg) for _ in range(m)]
                 for _ in range(g)]
        slstm = [init_slstm_block(generator, cfg) for _ in range(g)]
    return XLSTM(embed, torch.ones(cfg.d_model, dtype=cfg.dtype, device=dev),
                 mlstm, slstm,
                 None if cfg.tie_embeddings else init_embedding(generator,
                                                                cfg))


def _groups(params: XLSTM):
    """(mLSTM blocks, sLSTM block or None) of each group."""
    if not len(params.slstm):
        return [([blk], None) for blk in params.mlstm]
    return list(zip(params.mlstm, params.slstm))


def xlstm_forward(params: XLSTM, cfg: ModelConfig, *,
                  tokens: torch.Tensor | None = None,
                  embeds: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    x = (embed_tokens(params.embed, tokens, cfg.dtype)
         if embeds is None else embeds.to(cfg.dtype))

    def body(x, mls, sls):
        for layer in mls:
            x = sp_residual(x + mlstm_fwd(layer, x, cfg))
        if sls is not None:
            x = sp_residual(x + slstm_fwd(sls, x, cfg))
        return x

    step = remat(body, cfg)
    for mls, sls in _groups(params):
        x = step(x, mls, sls)
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params.out_table, x), aux


# ----------------------------------------------------------------------
def init_xlstm_cache(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str) -> dict:
    g, m = _layout(cfg)
    rules = get_rules()

    def pin(lead, tree):
        # every cache leaf is (B, H, ...) after the stacked lead dims
        return type(tree)(*(
            rules.place(a, *[None] * len(lead), "batch", "heads",
                        *[None] * (a.ndim - len(lead) - 2))
            for a in tree))

    if cfg.slstm_every == 0:
        return {"mlstm": pin((g,), init_mlstm_cache(cfg, batch, (g,),
                                                    device=device)),
                "length": 0}
    return {"mlstm": pin((g, m), init_mlstm_cache(cfg, batch, (g, m),
                                                  device=device)),
            "slstm": pin((g,), init_slstm_cache(cfg, batch, (g,),
                                                device=device)),
            "length": 0}


def xlstm_decode_step(params: XLSTM, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, vocab), cache with ``length + 1``);
    the cache's tensors are updated in place."""
    x = embed_tokens(params.embed, token, cfg.dtype)
    states = cache["mlstm"].state
    pure = cfg.slstm_every == 0
    for gi, (mls, sls) in enumerate(_groups(params)):
        for i, layer in enumerate(mls):
            at = (gi,) if pure else (gi, i)
            y, new = mlstm_step(layer, x, MLSTMCache(states[at]), cfg)
            states[at] = new.state
            x = x + y
        if sls is not None:
            sc = cache["slstm"]
            y, new = slstm_step(sls, x, SLSTMCache(*(t[gi] for t in sc)),
                                cfg)
            for t, n in zip(sc, new):
                t[gi] = n
            x = x + y
    x = rms_norm(x, params.ln_f.to(cfg.dtype), cfg.norm_eps)
    return (unembed(params.out_table, x),
            dict(cache, length=cache["length"] + 1))
