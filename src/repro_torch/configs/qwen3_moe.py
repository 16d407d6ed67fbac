"""qwen3-moe-235b-a22b [moe] — 128 experts top-8
[hf:Qwen/Qwen3-*; hf].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
every layer MoE (moe_every=1), head_dim=128 (decoupled from d_model).
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=0, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=1536, moe_every=1,
    capacity_factor=1.25, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=0, vocab=277, head_dim=16,
    n_experts=4, top_k=2, moe_d_ff=48, moe_every=1,
    dtype=torch.float32, remat=False)
