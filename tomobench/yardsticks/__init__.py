"""Frozen yardsticks: the least work each measured kernel's step needs
for its inputs, counted from shapes alone, and the card's data-sheet
peaks.  Nothing here reads the program, so a change to a kernel (or to
its own ``cost()``) never changes what it is measured against.

Filtered backprojection of ``S`` slices from ``A`` angles of ``D``
detector bins onto an ``N`` × ``N`` image:

* per pixel and angle, once for every slice of the step: the ray
  position ``t = x·cos θ + y·sin θ + centre`` (2 multiplies, 2 adds) and
  its fraction ``t - floor(t)`` (1 subtract): ``POSITION_OPS`` = 5;
* per pixel, angle and slice: the interpolation ``s0 + f·(s1 - s0)``
  (subtract, multiply, add) and the accumulation (add):
  ``UPDATE_OPS`` = 4;
* per pixel and slice: the scale by π/A and the division by μ:
  ``SCALE_OPS`` = 2;
* bytes: the float32 sinograms read once (S·A·D·4) and the float32
  images written once (S·N²·4).

Dark/flat correction of ``F`` frames of ``Y`` × ``X`` raw pixels of
``itemsize`` bytes: the raw bytes, F·Y·X·itemsize (what a GB/s of raw
input is taken over).
"""
from __future__ import annotations

import json
from pathlib import Path

POSITION_OPS = 5
UPDATE_OPS = 4
SCALE_OPS = 2


def backprojection(slices: int, angles: int, n_det: int, out_size: int
                   ) -> dict[str, float]:
    """The least operations and bytes of one backprojection step."""
    px = out_size * out_size
    flops = px * angles * (POSITION_OPS + UPDATE_OPS * slices) \
        + px * slices * SCALE_OPS
    nbytes = 4 * (slices * angles * n_det + slices * px)
    return {"flops": float(flops), "bytes": float(nbytes)}


def correction_raw_bytes(frames: int, rows: int, cols: int,
                         itemsize: int = 2) -> float:
    """The raw input's bytes of one correction step."""
    return float(frames * rows * cols * itemsize)


def peaks(part: str = "h100") -> dict:
    """The data-sheet peaks of one card (``yardsticks/<part>.json``)."""
    return json.loads((Path(__file__).with_name(f"{part}.json")).read_text())


def least_seconds(work: dict[str, float], cards: int,
                  part: str = "h100") -> float:
    """The least time ``cards`` cards take for ``work`` in float32 on
    the CUDA cores: the larger of its operation and byte bounds."""
    pk = peaks(part)
    return max(work["flops"] / (pk["fp32_flops_per_s"] * cards),
               work["bytes"] / (pk["hbm_bytes_per_s"] * cards))
