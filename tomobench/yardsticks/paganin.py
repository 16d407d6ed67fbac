"""The frozen count of Paganin's phase retrieval, from shapes alone.

A step retrieves ``frames`` projections, each padded to ``fft_y`` ×
``fft_x`` pixels (``P`` of them) by ``pad_y`` rows and ``pad_x``
columns on every side:

* operations: a forward and an inverse complex 2-D transform a frame,
  ``FFT_OPS`` · P · log2 P each (the usual count of a complex FFT of P
  points); the scale by the filter, the exponential and the logarithm
  are left out;
* bytes: the float32 projections read once and written once,
  ``2 · 4 · frames · (fft_y − 2·pad_y) · (fft_x − 2·pad_x)``.

The least time is :func:`tomobench.yardsticks.least_seconds` of these,
at ``h100.json``'s peaks.
"""
from __future__ import annotations

import math

FFT_OPS = 5


def retrieval(frames: int, fft_y: int, fft_x: int, pad_y: int,
              pad_x: int) -> dict[str, float]:
    """The least operations and bytes of one Paganin step."""
    p = fft_y * fft_x
    flops = frames * 2 * FFT_OPS * p * math.log2(p)
    nbytes = 2 * 4 * frames * (fft_y - 2 * pad_y) * (fft_x - 2 * pad_x)
    return {"flops": float(flops), "bytes": float(nbytes)}
