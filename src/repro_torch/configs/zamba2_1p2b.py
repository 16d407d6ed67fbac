"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
(arXiv:2411.15242; hf).

38L d_model=2048, shared attn 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  The shared transformer block's weights are reused at
every application (Zamba's parameter-sharing trick, attn_every=6:
6 groups of 6 mamba layers + shared block, then 2 trailing mamba
layers).  Sub-quadratic backbone: eligible for long_500k.
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "zamba2-1.2b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_heads=64, ssm_expand=2, conv_width=4,
    attn_every=6, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=293, head_dim=16,
    ssm_state=16, ssm_heads=4, ssm_expand=2, conv_width=4,
    attn_every=3, dtype=torch.float32, remat=False)
