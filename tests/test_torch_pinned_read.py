"""The read of a card's result into a page-locked host block
(``core.transport._read_off_card``) on the CPU: the cap on the bytes
the caching host allocator may own, as a pure function, and the
pageable fallback when the cap refuses or the page-locked allocation
raises.  The page-locked path itself is tested on the card
(``test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import DataSet, transport
from repro_torch.obs import Trace

GiB = 1 << 30
#: a host of 96 GiB: the cap is 24 GiB
PHYS = 96 * GiB
VOLUME = 419_430_400            # a 16-slice band's float32 volume


@pytest.mark.parametrize("nbytes, block", [
    (0, 0), (1, 1), (3, 4), (VOLUME, 536_870_912),
    (104_857_600, 134_217_728), (512 << 20, 512 << 20),
    ((512 << 20) + 1, 1 << 30)])
def test_blocks_round_up_to_a_power_of_two(nbytes, block):
    assert transport.pinned_block_bytes(nbytes) == block


@pytest.mark.parametrize("owned, nbytes, fits", [
    (0, VOLUME, True),
    (24 * GiB - (512 << 20), VOLUME, True),
    # 419,430,400 B would fit, the 536,870,912 B block does not
    (24 * GiB - 450_000_000, VOLUME, False),
    (24 * GiB, 0, True),
], ids=["below", "at_the_cap", "over_once_rounded", "zero_bytes"])
def test_the_cap_on_page_locked_bytes(owned, nbytes, fits):
    assert transport.pin_fits(owned, nbytes, PHYS) is fits


def _read(monkeypatch, fits):
    """``_read_off_card`` of a CPU tensor with the allocator's counters
    stubbed, ``pin_fits`` answering ``fits`` and every page-locked
    allocation raising, as on a host that has none left: (array, data,
    span)."""
    empty = torch.empty

    def no_pinned(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("no page-locked memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {
        "allocated_bytes.current": 0, "num_host_alloc": 0})
    monkeypatch.setattr(transport, "pin_fits", lambda *a: fits)
    monkeypatch.setattr(torch, "empty", no_pinned)
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    ds = DataSet("recon", (2, 3, 4), np.float32, ("z", "y", "x"),
                 backing=torch.from_numpy(data.copy()), trace=Trace())
    vol = transport._read_off_card(ds, ds.backing)
    (span,) = ds.trace.spans()
    return vol, data, span


@pytest.mark.parametrize("fits", [False, True],
                         ids=["cap_refuses", "allocation_raises"])
def test_a_refused_or_failed_block_falls_back_to_pageable(monkeypatch, fits):
    vol, data, span = _read(monkeypatch, fits)
    np.testing.assert_array_equal(vol, data)
    assert vol.flags.c_contiguous and vol.flags.writeable
    assert span.name == "transport.to_host"
    assert span.attrs == {"bytes": data.nbytes, "dataset": "recon",
                          "device": "cpu", "pinned": False,
                          "reused": False, "staged": False}
