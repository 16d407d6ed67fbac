"""On the card: one short run of each one-card cell, at its own size,
correct; and the control at the chain's own size reads not correct.
Skips without a card."""
from __future__ import annotations

import io
import json

import pytest
import torch

from tomobench import run

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["chain-band16", "tune-sweep4-over"])
def test_one_card_cell_runs_correct(card, workload):
    out = io.StringIO()
    assert run.run(workload, 2**32 + 15, 3.0, False, out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["kind"] == torch.cuda.get_device_name(card)


def test_the_control_fails_at_the_chains_size(card):
    out = io.StringIO()
    assert run.run("chain-band16", 7, 2.0, False, control="bf16",
                   out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is False
