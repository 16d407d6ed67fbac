"""chatglm3-6b [dense] — 2-d (half) RoPE, GQA kv=2 (arXiv:2406.12793; hf).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM's 2-d rope == rotary on half the head dims (rope_fraction=0.5).
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "chatglm3-6b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128,
    rope_theta=10_000.0, rope_fraction=0.5, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=112, vocab=263, head_dim=16, rope_fraction=0.5,
    dtype=torch.float32, remat=False)
