"""The frozen counts at the cells' geometries, pinned."""
from __future__ import annotations

import pytest

from tomobench import yardsticks


def test_backprojection_count_of_a_band():
    w = yardsticks.backprojection(16, 1801, 2560, 2560)
    # 2560² × 1801 × (5 + 4·16) + 2560² × 16 × 2
    assert w["flops"] == 814_619_033_600.0
    # sinograms 16·1801·2560·4 + images 16·2560²·4
    assert w["bytes"] == 714_506_240.0
    assert yardsticks.least_seconds(w, 1) == pytest.approx(
        814_619_033_600.0 / 67e12)


def test_backprojection_count_of_a_sweep_gang_and_a_split_scan():
    assert yardsticks.backprojection(16, 1801, 2560, 2560) == \
        yardsticks.backprojection(4 * 4, 1801, 2560, 2560)
    w = yardsticks.backprojection(1080, 1800, 2560, 2560)
    assert w["flops"] == 51_033_931_776_000.0
    assert w["bytes"] == 48_218_112_000.0
    assert yardsticks.least_seconds(w, 4) == pytest.approx(
        51_033_931_776_000.0 / (4 * 67e12))


def test_correction_bytes_and_peaks():
    assert yardsticks.correction_raw_bytes(1801, 16, 2560) == 147_537_920.0
    pk = yardsticks.peaks()
    assert pk["fp32_flops_per_s"] == 67e12
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["hbm_bytes"] == 80e9
