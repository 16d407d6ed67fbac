"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA (arXiv:2412.08905; hf).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
Partial rotary factor 0.75 per the released config.
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "phi4-mini-3.8b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    rope_theta=10_000.0, rope_fraction=0.75, dtype=torch.bfloat16,
    tie_embeddings=True)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=311, head_dim=16, rope_fraction=0.75,
    dtype=torch.float32, remat=False, tie_embeddings=True)
