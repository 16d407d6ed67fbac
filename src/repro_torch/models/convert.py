"""Load the JAX package's parameters into the port's modules.

``params`` is the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), each layer leaf stacked over its
layers on the leading axes as the reference stacks it:

- dense/moe/vlm: ``embed``, an optional ``unembed``, ``ln_f``, and
  ``layers`` — one dict per sub-layer kind of a group (``mlp`` or
  ``moe`` with ``router``, ``w_gate``/``w_up``/``w_down`` (E, d, f) and
  an optional ``shared`` MLP), stacked over the groups;
- hybrid (Zamba2): ``groups`` (G, k, ...), ``shared_ln1/attn/ln2/mlp``,
  an optional ``tail`` (r, ...), ``ln_f``, ``embed``, ``unembed``;
- ssm (xLSTM): ``mlstm`` (G, m, ...) or (G, ...), ``slstm`` (G, ...),
  ``ln_f``, ``embed``, ``unembed``;
- encdec (Whisper): ``enc_layers``, ``dec_layers`` (with ``xattn`` and
  ``ln_x``; layer norms are ``{scale, bias}``), ``enc_ln_f``,
  ``dec_ln_f``, ``embed``.

Every weight keeps its shape (``wq`` (d, H, hd), ``wo`` (H, hd, d), ...),
so no transpose can go wrong.  Tables stay in ``cfg.param_dtype``; the
weights the reference keeps and uses in fp32 (the MoE router, Mamba's
``A_log``/``dt_bias``/``D``, sLSTM's ``r_gates``) stay fp32; every other
weight is stored in ``cfg.dtype`` for serving, and with ``for_training``
in ``cfg.param_dtype`` (the reference's fp32 values, unrounded) with
``requires_grad`` set.

``params_to_jax`` goes the other way: the port's tree as the reference's
layout of numpy arrays (stacked over layers), to compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention
from .common import ModelConfig, trainable, training_storage
from .mamba2 import MambaBlock
from .mlp import MLP
from .moe import MoE
from .transformer import LM, Block, _group_structure
from .whisper import DecoderLayer, EncoderLayer, LayerNorm, Whisper
from .xlstm import MLSTMBlock, SLSTMBlock
from .xlstm_model import XLSTM, _layout as xlstm_layout
from .zamba import Zamba, _layout as zamba_layout

#: leaves the reference keeps (and computes with) in fp32
FP32_LEAVES = ("router", "A_log", "dt_bias", "D", "r_gates")


def params_from_jax(params: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda", *,
                    for_training: bool = False) -> nn.Module:
    """The port's model tree holding ``params``; a trainer's
    (:func:`common.trainable`, every weight in ``cfg.param_dtype``) with
    ``for_training``."""
    if for_training:
        return trainable(params_from_jax(params, training_storage(cfg),
                                         device))
    dev = resolve_device(device)
    fam = cfg.family
    if fam != "encdec" and ("unembed" in params) == cfg.tie_embeddings:
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'unembed' in params else 'lacks'} "
                         f"an unembed table")

    def tensor(a, dtype=cfg.dtype) -> torch.Tensor:
        # float32 first: numpy's bfloat16 is not a torch dtype; exact
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(dev, dtype)

    def leaf(name, a):
        return tensor(a, torch.float32 if name in FP32_LEAVES else cfg.dtype)

    def at(tree, idx):
        """The sub-tree of one layer: every leaf indexed by ``idx``."""
        if isinstance(tree, dict):
            return {k: at(v, idx) for k, v in tree.items()}
        return tree[idx]

    def mlp(p) -> MLP:
        return MLP(tensor(p["w_up"]), tensor(p["w_down"]),
                   tensor(p["w_gate"]) if "w_gate" in p else None)

    def attn(p) -> Attention:
        return Attention(*(tensor(p[n]) for n in ("wq", "wk", "wv", "wo")))

    def table(name):
        out = params.get(name)
        return None if out is None else tensor(out, cfg.param_dtype)

    def depth(a, want, what):
        """``a``, a leaf of ``what``, is stacked ``want`` deep."""
        got = np.shape(a)[:len(want)]
        if tuple(got) != tuple(want):
            raise ValueError(f"{what} stacked {tuple(got)} deep, "
                             f"{cfg.arch_id} has {tuple(want)}")

    if fam in ("dense", "moe", "vlm"):
        n_groups, kinds = _group_structure(cfg)
        subs = list(params["layers"])
        if len(subs) != len(kinds):
            raise ValueError(f"{len(subs)} sub-layer kinds in the tree, "
                             f"{cfg.arch_id} has {len(kinds)}")
        for sub in subs:
            depth(sub["ln1"], (n_groups,), "layers")

        def ffn(sub) -> MLP | MoE:
            if "moe" not in sub:
                return mlp(sub["mlp"])
            m = sub["moe"]
            return MoE(*(leaf(n, m[n])
                         for n in ("router", "w_gate", "w_up", "w_down")),
                       mlp(m["shared"]) if "shared" in m else None)

        layers = [Block(tensor(s["ln1"]), attn(s["attn"]), tensor(s["ln2"]),
                        ffn(s))
                  for s in (at(sub, g) for g in range(n_groups)
                            for sub in subs)]
        return LM(table("embed"), layers, tensor(params["ln_f"]),
                  table("unembed"))

    def mamba(p) -> MambaBlock:
        return MambaBlock(*(leaf(n, p[n]) for n in (
            "ln", "w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D",
            "norm", "w_out")))

    if fam == "hybrid":
        g, k, r = zamba_layout(cfg)
        depth(params["groups"]["ln"], (g, k), "groups")
        if r:
            depth(params["tail"]["ln"], (r,), "tail")
        return Zamba(
            table("embed"),
            [[mamba(at(params["groups"], (gi, i))) for i in range(k)]
             for gi in range(g)],
            tensor(params["shared_ln1"]), attn(params["shared_attn"]),
            tensor(params["shared_ln2"]), mlp(params["shared_mlp"]),
            tensor(params["ln_f"]),
            [mamba(at(params["tail"], i)) for i in range(r)],
            table("unembed"))

    if fam == "ssm":
        g, m = xlstm_layout(cfg)

        def mlstm(p) -> MLSTMBlock:
            return MLSTMBlock(*(leaf(n, p[n]) for n in (
                "ln", "wq", "wk", "wv", "w_if", "w_o", "w_out", "norm")))

        def slstm(p) -> SLSTMBlock:
            return SLSTMBlock(*(leaf(n, p[n]) for n in (
                "ln", "w_gates", "r_gates", "w_out", "norm")))

        if cfg.slstm_every == 0:
            depth(params["mlstm"]["ln"], (g,), "mlstm")
            blocks = [mlstm(at(params["mlstm"], gi)) for gi in range(g)]
            cells = []
        else:
            depth(params["mlstm"]["ln"], (g, m), "mlstm")
            depth(params["slstm"]["ln"], (g,), "slstm")
            blocks = [[mlstm(at(params["mlstm"], (gi, i))) for i in range(m)]
                      for gi in range(g)]
            cells = [slstm(at(params["slstm"], gi)) for gi in range(g)]
        return XLSTM(table("embed"), tensor(params["ln_f"]), blocks, cells,
                     table("unembed"))

    if fam == "encdec":
        def ln(p) -> LayerNorm:
            return LayerNorm(tensor(p["scale"]), tensor(p["bias"]))

        n_enc = cfg.n_enc_layers or cfg.n_layers
        enc, dec = params["enc_layers"], params["dec_layers"]
        depth(enc["ln1"]["scale"], (n_enc,), "enc_layers")
        depth(dec["ln1"]["scale"], (cfg.n_layers,), "dec_layers")
        return Whisper(
            [EncoderLayer(ln(p["ln1"]), attn(p["attn"]), ln(p["ln2"]),
                          mlp(p["mlp"]))
             for p in (at(enc, i) for i in range(n_enc))],
            [DecoderLayer(ln(p["ln1"]), attn(p["attn"]), ln(p["ln_x"]),
                          attn(p["xattn"]), ln(p["ln2"]), mlp(p["mlp"]))
             for p in (at(dec, i) for i in range(cfg.n_layers))],
            ln(params["enc_ln_f"]), ln(params["dec_ln_f"]), table("embed"))

    raise ValueError(f"unknown family {fam!r}")


def params_to_jax(module: nn.Module, cfg: ModelConfig) -> dict:
    """The port's tree as the reference's: nested dicts of numpy arrays
    (fp32 for floating weights), each layer leaf stacked over its layers
    on the leading axes as the reference stacks it; dense/moe/vlm
    ``layers`` is a tuple with one stack per sub-layer kind of a group."""

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def tree(m):
        """A module -> {name: array or sub-tree}; a list of modules -> their
        trees stacked leaf by leaf (nested lists stack nested)."""
        if isinstance(m, (list, nn.ModuleList)):
            return _stack([tree(x) for x in m])
        out = {n: arr(p) for n, p in m.named_parameters(recurse=False)}
        for n, child in m.named_children():
            if isinstance(child, nn.ModuleList) and not len(child):
                continue                       # no tail, no sLSTM
            if isinstance(m, Block) and n == "ffn":
                n = "moe" if isinstance(child, MoE) else "mlp"
            if isinstance(m, LM) and n == "layers":
                g = len(_group_structure(cfg)[1])
                out[n] = tuple(tree(list(child[i::g])) for i in range(g))
            else:
                out[n] = tree(child)
        return out

    return tree(module)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
