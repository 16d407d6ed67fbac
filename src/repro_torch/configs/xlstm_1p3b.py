"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks 7:1 (arXiv:2405.04517).

48L d_model=2048 4H d_ff=0 vocab=50304.  slstm_every=8 gives the
released 7:1 mLSTM:sLSTM ratio (6 sLSTM blocks).  Sub-quadratic:
eligible for the long_500k cell.
"""
import torch
from ..models.common import ModelConfig

ARCH_ID = "xlstm-1.3b"

FULL = ModelConfig(
    arch_id=ARCH_ID, family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8, dtype=torch.bfloat16)

SMOKE = ModelConfig(
    arch_id=ARCH_ID + "-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=257, slstm_every=4,
    dtype=torch.float32, remat=False)
