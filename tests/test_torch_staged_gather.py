"""The gather of a sharded dataset off the cards through page-locked
staging blocks (``core.transport._gather_off_cards``), on the card.

Slots are the visible cards, or four slots on the one card where only
one is visible.  The read equals the pageable gather
(``ShardedTensor.to("cpu")``) bit for bit; its span says it staged; a
second read takes its staging blocks from the caching host allocator;
the page-locked bytes stay within two staging blocks a slot, and no
card's allocated memory grows by more than one chunk.

Every test here carries the ``gpu`` marker and skips without a CUDA
device.  The file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_staged_gather.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CudaTransport, DataSet, ShardedTensor, transport
from repro_torch.obs import Trace

pytestmark = pytest.mark.gpu

MiB = 1 << 20


@pytest.fixture
def slots():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cards = transport.slots_on("cuda")
    return cards if len(cards) > 1 else cards * 4


def _sharded(slots, shape, dim, seed, strided=False):
    """A ShardedTensor of ``shape`` split along ``dim`` over ``slots``
    (None: a replica a slot), each block made on its card by a kernel
    queued just before the read (no synchronise).  ``strided``: each
    block a view into a wider tensor, not contiguous."""
    k = len(slots)
    sizes = ([None] * k if dim is None
             else transport.split_sizes(shape[dim], k))
    shards = []
    for j, (dev, n) in enumerate(zip(slots, sizes)):
        g = torch.Generator(device=dev).manual_seed(seed + j)
        sh = list(shape)
        if n is not None:
            sh[dim] = n
        if strided:
            wide = torch.randn(sh[:-1] + [sh[-1] + 3], device=dev,
                               generator=g)
            t = wide[..., 1:sh[-1] + 1]
            assert not t.is_contiguous()
        else:
            t = torch.randn(sh, device=dev, generator=g)
        shards.append(t.mul_(2).add_(1))
    if dim is None:
        shards = [shards[0].to(dev) for dev in slots]
    return ShardedTensor(shards, dim, slots)


def _read(st, shape):
    ds = DataSet("recon", shape, np.float32, ("z", "y", "x"), backing=st,
                 trace=Trace())
    vol = CudaTransport(st.devices[0]).read(ds)
    (span,) = [s for s in ds.trace.spans() if s.name == "transport.to_host"]
    return vol, span


# (shape, dim, strided) at 1 MiB staging blocks: a row of 64 x 1024
# float32 is 256 KiB, so a chunk is 4 rows (25 of 10 x 1024)
CASES = {
    "even": ((64, 64, 1024), 0, False),
    "uneven": ((37, 64, 1024), 0, False),
    "split_dim_1": ((40, 37, 1024), 1, False),
    "replicated": ((10, 64, 1024), None, False),
    "strided_blocks": ((21, 64, 1024), 0, True),
}


@pytest.mark.parametrize("case", CASES)
def test_staged_gather_equals_the_pageable_gather(slots, monkeypatch, case):
    shape, dim, strided = CASES[case]
    monkeypatch.setattr(transport, "STAGE_BYTES", MiB)
    st = _sharded(slots, shape, dim, seed=11, strided=strided)
    vol, span = _read(st, shape)
    want = st.to("cpu").numpy()
    assert vol.dtype == want.dtype and vol.shape == want.shape == shape
    assert vol.tobytes() == want.tobytes()
    assert vol.flags.c_contiguous and vol.flags.writeable
    blocks = st.blocks()
    chunks = sum(len(transport.stage_chunks(
        b.shape[0], transport.stage_rows(b.shape, 4))) for b in blocks)
    assert span.attrs["pinned"] is True
    assert span.attrs["slots"] == len(slots)
    assert span.attrs["chunks"] == chunks > len(blocks)
    assert span.attrs["bytes"] == vol.nbytes


def test_a_second_gather_reuses_its_staging_blocks(slots):
    """At the real staging size: 20 slices of 2560² float32 a slot, two
    chunks of 10.  The page-locked bytes grow by at most two staging
    blocks a slot, no card's allocated memory by more than one chunk,
    and the second gather allocates nothing page-locked."""
    shape = (20 * len(slots), 2560, 2560)
    chunk = 10 * 2560 * 2560 * 4
    st = _sharded(slots, shape, 0, seed=5)
    cards = list(dict.fromkeys(slots))
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    before = {d: torch.cuda.memory_allocated(d) for d in cards}
    host0 = torch.cuda.host_memory_stats()
    vol, first = _read(st, shape)
    host1 = torch.cuda.host_memory_stats()
    assert first.attrs["pinned"] is True
    assert first.attrs["chunks"] == 2 * len(slots)
    assert (host1["allocated_bytes.current"]
            - host0["allocated_bytes.current"]
            <= 2 * transport.STAGE_BYTES * len(slots))
    for d in cards:
        assert torch.cuda.max_memory_allocated(d) - before[d] <= chunk
    want = st.to("cpu").numpy()
    assert vol.tobytes() == want.tobytes()
    del vol
    vol, again = _read(st, shape)
    assert again.attrs["pinned"] is True and again.attrs["reused"] is True
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == \
        host1["num_host_alloc"]
    assert vol.tobytes() == want.tobytes()
