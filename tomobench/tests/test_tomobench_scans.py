"""The scan generator: closed-form projections against a numerical
line integral, rows independent of the band they are made in, and the
counts a detector would give."""
from __future__ import annotations

import math

import numpy as np
import torch

from tomobench import scans

PARAMS = {"dark_counts": [80, 120], "flat_counts": [30000, 42000],
          "gain_sd": 0.01, "mu_peak": 1.5}
CPU = torch.device("cpu")


def line_integral(model, row, theta, s, du=0.005):
    """Σ value × chord length of each ellipse along the ray at angle
    ``theta`` and offset ``s`` (pixels), by sampling the ray finely."""
    u = np.arange(-model.n_det, model.n_det, du)
    x = s * math.cos(theta) - u * math.sin(theta)
    y = s * math.sin(theta) + u * math.cos(theta)
    total = 0.0
    for (_, a, b, x0, y0, phi), v in zip(model.ellipses,
                                         model.row_weights([row])[0]):
        xr = (x - x0) * math.cos(phi) + (y - y0) * math.sin(phi)
        yr = -(x - x0) * math.sin(phi) + (y - y0) * math.cos(phi)
        total += v * du * np.count_nonzero((xr / a) ** 2 + (yr / b) ** 2
                                           <= 1.0)
    return total


def test_closed_form_matches_a_numerical_line_integral():
    m = scans.ScanModel(2**40 + 3, 64, 8, 24, PARAMS)
    proj = m.ellipse_projections(CPU).numpy()          # (K, A, D)
    w = m.row_weights([5])[0]
    exact = np.einsum("k,kad->ad", w, proj)
    th = scans.angles(24)
    worst = 0.0
    for a in (0, 5, 11, 17):
        for d in range(0, 64, 3):
            s = d - (64 - 1) / 2.0
            worst = max(worst, abs(line_integral(m, 5, th[a], s)
                                   - exact[a, d]))
    # ten ellipses, each chord within two sample steps
    assert worst < 0.2
    assert np.abs(exact).max() > 20


def test_rows_do_not_depend_on_their_band():
    m = scans.ScanModel(77, 32, 12, 16, PARAMS)
    whole = scans.whole(m, CPU, block=5)
    part = m.raw(range(4, 8), CPU)
    assert np.array_equal(whole["data"][:, 4:8], part["data"])
    assert np.array_equal(whole["dark"][4:8], part["dark"])
    assert np.array_equal(whole["flat"][4:8], part["flat"])
    assert part["data"].flags.c_contiguous


def test_seeds_and_scans_differ_and_repeat():
    a = scans.ScanModel(5, 32, 4, 16, PARAMS).raw(range(4), CPU)
    b = scans.ScanModel(5, 32, 4, 16, PARAMS).raw(range(4), CPU)
    c = scans.ScanModel(6, 32, 4, 16, PARAMS).raw(range(4), CPU)
    d = scans.ScanModel(5, 32, 4, 16, PARAMS, scan=1).raw(range(4),
                   CPU)
    assert np.array_equal(a["data"], b["data"])
    assert not np.array_equal(a["data"], c["data"])
    assert not np.array_equal(a["data"], d["data"])


def test_counts_are_a_detectors():
    m = scans.ScanModel(2**33, 64, 6, 32, PARAMS)
    b = m.raw(range(6), CPU)
    assert b["data"].dtype == np.uint16 and b["data"].shape == (32, 6, 64)
    assert 80 <= b["dark"].min() and b["dark"].max() <= 120
    assert 30000 <= b["flat"].min() and b["flat"].max() <= 42000
    # the phantom attenuates; no count reaches the flat's ceiling
    trans = (b["data"].astype(float) - b["dark"]) / (b["flat"] - b["dark"])
    assert 0.15 < trans.min() and trans.max() < 1.1
    # adjacent rows differ (each row's values are modulated)
    assert not np.allclose(m.row_weights([0]), m.row_weights([1]))
