"""granite-8b [dense] — llama-arch code model (arXiv:2405.04324; hf).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "granite-8b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128,
    rope_theta=10_000.0, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=257, head_dim=16,
    dtype=torch.float32, remat=False)
