"""whisper-small [audio] — enc-dec backbone, conv frontend STUB
(arXiv:2212.04356).  12+12L d_model=768 12H d_ff=3072 vocab=51865.

input_specs() provides precomputed mel-frame embeddings (B, 1500, d)
per the assignment; the conv stem is not modelled.  No rope
(sinusoidal absolute positions).
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "whisper-small"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=51865, rope_fraction=0.0,
    max_frames=1500, frontend="mel", dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=269, rope_fraction=0.0, max_frames=16,
    frontend="mel", dtype=torch.float32, remat=False)
