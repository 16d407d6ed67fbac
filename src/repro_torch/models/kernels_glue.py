"""Thin indirection so model code imports kernels from one place."""
from ..kernels.flash_attention.ops import attention as flash_attention

__all__ = ["flash_attention"]
