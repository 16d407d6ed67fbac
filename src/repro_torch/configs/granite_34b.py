"""granite-34b [dense] — llama-arch code model (arXiv:2405.04324; hf).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
kv=1 is MQA: KV projections replicate across the model axis (the
standard MQA TP fallback; see models/sharding.py).
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "granite-34b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    rope_theta=10_000.0, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=1,
    d_ff=192, vocab=257, head_dim=16,
    dtype=torch.float32, remat=False)
