"""Architecture registry + assigned input shapes + input_specs().

The 10 assigned architectures (× 4 shapes = 40 nominal cells).  Cells
mandated skipped: long_500k for the 8 pure-full-attention archs (needs
sub-quadratic attention) — it runs only for xlstm-1.3b and zamba2-1.2b.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.common import ModelConfig

_MODULES = {
    "granite-34b": "granite_34b",
    "granite-8b": "granite_8b",
    "phi4-mini-3.8b": "phi4_mini",
    "chatglm3-6b": "chatglm3_6b",
    "xlstm-1.3b": "xlstm_1p3b",
    "whisper-small": "whisper_small",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen3-moe-235b-a22b": "qwen3_moe",
    "llava-next-34b": "llava_next_34b",
    "zamba2-1.2b": "zamba2_1p2b",
}

ARCH_IDS = list(_MODULES)

# assigned LM shapes: name -> (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

SUBQUADRATIC = {"xlstm-1.3b", "zamba2-1.2b"}


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.SMOKE if smoke else mod.FULL


def cell_supported(arch_id: str, shape: str) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch × shape) cell."""
    if shape == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{arch_id} is full-attention (skip per assignment)")
    return True, ""


def all_cells(include_skipped: bool = False
              ) -> list[tuple[str, str, bool, str]]:
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = cell_supported(a, s)
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out


# ----------------------------------------------------------------------
class TensorSpec(NamedTuple):
    """A step input's shape and dtype: what a fake tensor is made from
    (``torch.empty(spec.shape, dtype=spec.dtype)`` under a fake-tensor
    mode); allocates nothing."""
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch_id: str
    shape_name: str
    kind: str                   # train | prefill | decode
    batch: dict[str, Any]       # TensorSpecs for the step inputs
    seq_len: int
    global_batch: int
    notes: str = ""


def input_specs(arch_id: str, shape_name: str, *,
                cfg: ModelConfig | None = None) -> CellSpec:
    """(shape, dtype) stand-ins for every model input of a cell — no
    device allocation."""
    cfg = cfg or get_config(arch_id)
    seq, gb, kind = SHAPES[shape_name]
    fam = cfg.family
    i32 = torch.int32

    if kind in ("train", "prefill"):
        if fam == "encdec":
            t = cfg.max_frames or 1500
            batch = {
                "frames": TensorSpec((gb, t, cfg.d_model), torch.bfloat16),
                "tokens": TensorSpec((gb, seq), i32),
                "labels": TensorSpec((gb, seq), i32),
            }
        elif fam == "vlm":
            from .llava_next_34b import PATCH_TOKENS
            pt = min(PATCH_TOKENS, seq // 2)
            batch = {
                "tokens": TensorSpec((gb, seq - pt), i32),
                "patches": TensorSpec((gb, pt, cfg.d_model),
                                      torch.bfloat16),
                "labels": TensorSpec((gb, seq), i32),
            }
        else:
            batch = {
                "tokens": TensorSpec((gb, seq), i32),
                "labels": TensorSpec((gb, seq), i32),
            }
        if kind == "prefill":
            batch.pop("labels")
        return CellSpec(arch_id, shape_name, kind, batch, seq, gb)

    # decode: one new token against a seq-long cache
    batch = {"token": TensorSpec((gb, 1), i32)}
    return CellSpec(arch_id, shape_name, "decode", batch, seq, gb,
                    notes="cache from model.init_cache under the mesh")


def smoke_batch(cfg: ModelConfig, *, batch: int = 2, seq: int = 16,
                seed: int = 0) -> dict[str, np.ndarray]:
    """Concrete small batch for CPU smoke tests of any family."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    if cfg.family == "encdec":
        t = min(cfg.max_frames or 16, 16)
        return {"frames": rng.normal(size=(batch, t, cfg.d_model)
                                     ).astype(np.float32),
                "tokens": toks, "labels": toks.copy()}
    if cfg.family == "vlm":
        pt = max(2, seq // 4)
        patches = rng.normal(size=(batch, pt, cfg.d_model)
                             ).astype(np.float32)
        labels = np.concatenate(
            [np.full((batch, pt), -1, np.int32), toks], axis=1)
        return {"tokens": toks, "patches": patches, "labels": labels}
    return {"tokens": toks, "labels": toks.copy()}
