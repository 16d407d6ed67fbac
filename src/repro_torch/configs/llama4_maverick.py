"""llama4-maverick-400b-a17b [moe] — MoE top-1, early fusion
[hf:meta-llama/Llama-4-*; unverified].

48L d_model=5120 40H (GQA kv=8) dense d_ff=8192 vocab=202048,
MoE 128 experts top-1 + 1 shared expert, alternating dense/MoE layers
(moe_every=2, the released interleave pattern).
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    n_experts=128, top_k=1, moe_d_ff=8192, moe_every=2,
    n_shared_experts=1, capacity_factor=1.25, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=271, head_dim=16,
    n_experts=4, top_k=1, moe_d_ff=96, moe_every=2,
    n_shared_experts=1, dtype=torch.float32, remat=False)
