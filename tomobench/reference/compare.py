"""The comparison that decides ``correct``: each compared number beside
its limit.

``recon_max_rel_err`` is, over every compared slice, the largest
``max |program − reference| / max |reference|`` of the slice (a slice
that is not finite, or of the wrong shape, reads infinity)."""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch


@dataclasses.dataclass
class Check:
    """One compared number, its limit, and whether it keeps it."""

    name: str
    value: float
    limit: float | None
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.limit is not None and math.isfinite(self.value) \
            and self.value <= self.limit

    def line(self) -> str:
        lim = "none" if self.limit is None else f"{self.limit!r}"
        return (f"check {self.name} = {self.value!r} (limit {lim}) "
                f"{'ok' if self.ok else 'FAIL'}"
                + (f"; {self.detail}" if self.detail else ""))

    def as_json(self) -> dict:
        return {"value": self.value if math.isfinite(self.value) else None,
                "limit": self.limit}


def slice_rel_err(program: np.ndarray | torch.Tensor,
                  reference: torch.Tensor) -> float:
    """``max |program − reference| / max |reference|`` of one slice."""
    ref = reference.to(torch.float64)
    prog = torch.as_tensor(np.asarray(program)).to(ref.device,
                                                    torch.float64)
    if prog.shape != ref.shape or not bool(torch.isfinite(prog).all()):
        return math.inf
    scale = float(ref.abs().max())
    if scale == 0.0:
        return math.inf
    return float((prog - ref).abs().max()) / scale


def worst(errors: Iterable[float]) -> float:
    errors = list(errors)
    return max(errors) if errors else math.inf


def limit_of(limits: dict, name: str) -> float | None:
    entry = limits.get(name) or {}
    lim = entry.get("limit")
    return None if lim is None else float(lim)
