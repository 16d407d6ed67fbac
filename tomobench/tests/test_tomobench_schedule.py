"""The open loop's arrivals: a Poisson process drawn from the run's
seed, the same for one seed."""
from __future__ import annotations

import numpy as np

from tomobench.drivers.open_sweeps import schedule


def test_same_seed_same_schedule():
    big = 2**33 + 7
    assert schedule(big, 3.84, 40) == schedule(big, 3.84, 40)
    assert schedule(big, 3.84, 40) != schedule(big + 1, 3.84, 40)


def test_arrivals_lie_in_the_window_in_order():
    offs = schedule(3, 3.84, 40)
    assert offs[0] == 0.0 and offs[-1] < 40
    assert all(b > a for a, b in zip(offs, offs[1:]))


def test_gaps_are_independent_exponential_draws():
    gaps, counts = [], []
    for seed in range(200):
        offs = schedule(seed, 3.84, 40)
        counts.append(len(offs))
        gaps += list(np.diff(offs))
    gaps = np.array(gaps)
    # exponential: mean 1/rate, standard deviation equal to the mean,
    # and about e**-1 of the gaps longer than the mean
    assert abs(gaps.mean() * 3.84 - 1) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1) < 0.03
    assert abs((gaps > 1 / 3.84).mean() - np.exp(-1)) < 0.01
    # successive gaps uncorrelated, counts Poisson (variance = mean)
    assert abs(np.corrcoef(gaps[:-1], gaps[1:])[0, 1]) < 0.02
    assert abs(np.mean(counts) - 3.84 * 40) < 2.0
    assert 0.7 < np.var(counts) / np.mean(counts) < 1.3
