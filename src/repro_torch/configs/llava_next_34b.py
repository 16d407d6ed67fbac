"""llava-next-34b [vlm] — anyres tiling STUB
[hf:llava-hf/llava-v1.6-*; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
input_specs() provides pre-projected patch embeddings (the anyres
vision tower + projector are stubbed per the assignment); patches are
prepended to the token embeddings.
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "llava-next-34b"
PATCH_TOKENS = 2048          # anyres tiles x 576 patches, truncated stub

FULL = ModelConfig(
    arch_id=ARCH_ID, family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    frontend="patch", dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=283, head_dim=16,
    frontend="patch", dtype=torch.float32, remat=False)
