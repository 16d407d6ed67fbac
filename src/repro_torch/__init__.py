"""PyTorch/CUDA port of the Savu-style tomography framework.

Mirrors ``repro`` module for module; the TPU's Pallas kernels become
hand-written CUDA kernels under ``kernels/`` with a plain PyTorch
version beside each.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from .device import probe, resolve_device

__all__ = ["probe", "resolve_device"]
