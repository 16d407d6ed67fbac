"""Where the port runs: a capability probe and the device rule.

Every entry point of the port runs on the card unless the caller asks
for the CPU.  :func:`resolve_device` is the one place that rule is
enforced: asking for ``"cuda"`` on a host without a CUDA device raises;
it never carries on on the CPU.
"""
from __future__ import annotations

import os
import shutil
from typing import Any

import torch


def nvcc_path() -> str | None:
    """The CUDA compiler the kernel build uses, or None when absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def probe() -> dict[str, Any]:
    """What this host offers the port: CUDA present, the card's name
    and compute capability, the ``nvcc`` path, torch and CUDA versions."""
    cuda = torch.cuda.is_available()
    return {
        "cuda": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "capability": (tuple(torch.cuda.get_device_capability(0))
                       if cuda else None),
        "nvcc": nvcc_path(),
        "torch": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def _fake_mode():
    from torch._guards import detect_fake_mode
    return detect_fake_mode()


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device
    is asked for and this host has none.  Under a fake-tensor mode (the
    dry-runs, ``launch.mesh.fake_tensors``) nothing is allocated, so the
    card's device type is accepted without a card."""
    dev = torch.device(device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and _fake_mode() is None):
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}); pass device='cpu' to run the plain "
            f"PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: the port runs "
                         f"on 'cuda' or, when asked, on 'cpu'")
    return dev
