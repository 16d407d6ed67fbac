"""The hand-off of a host source to a card through page-locked staging
blocks (``core.transport._stage_to`` for one card, the staged
``ShardedTransport._scatter`` for the slots).

On the CPU: the plan of lanes and chunks, and the staged copy itself
with the page-locked allocations stubbed (plain host tensors, the
allocator's counters faked), against ``torch.from_numpy``.  On the card
(``gpu`` marker, skipped without a CUDA device): the staged upload
equals ``torch.from_numpy(a).to(dev)`` bit for bit, a second upload
takes its staging blocks from the caching host allocator, and a
scatter over four slots of one card equals the slot-after-slot copy.
The file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_staged_upload.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (CudaTransport, DataSet, ShardedTransport,
                              transport)
from repro_torch.obs import Trace

MiB = 1 << 20
#: a 16-row band of the PCO.edge scan: 1801 projections of 16 x 2560
BAND = (1801, 16, 2560)
#: a slot's block of the whole scan over four cards: 451 of 1801
SLOT = (451, 2160, 2560)


@pytest.mark.parametrize("shape, itemsize, lanes, runs, chunks", [
    # 8 runs of 226/225 projections, each one staging block's chunk
    (BAND, 2, 8, 8, 8),
    (BAND, 2, 3, 3, 3),
    # a slot's block at two lanes a slot: 24 rows (265 MB) a chunk,
    # 9 whole and a ragged one a lane
    (SLOT, 2, 2, 2, 20),
    # 1801 x 240 x 2560: 218 rows a chunk, 226 or 225 a lane, a ragged
    # 8 or 7
    ((1801, 240, 2560), 2, 8, 8, 16),
    # fewer rows than lanes: a lane a row
    ((3, 1 << 22), 1, 8, 3, 3),
], ids=["band", "band_three_lanes", "slot_two_lanes", "two_chunks_a_lane",
        "three_rows"])
def test_the_plan_takes_every_row_once(shape, itemsize, lanes, runs,
                                       chunks):
    assert transport.UPLOAD_BYTES == 64 * MiB
    assert transport.UPLOAD_LANES == 8 and transport.STAGE_BYTES == 256 * MiB
    plan = transport.upload_plan(shape, itemsize, lanes)
    assert len(plan) == runs
    sizes = [hi - lo for lo, hi in plan]
    assert max(sizes) - min(sizes) <= 1
    taken = []
    for lo, hi in plan:
        rows = transport.stage_rows((hi - lo, *shape[1:]), itemsize)
        assert rows * itemsize * int(np.prod(shape[1:])) <= \
            transport.STAGE_BYTES
        mine = [(lo + a, lo + b) for a, b in transport.stage_chunks(
            hi - lo, rows)]
        assert all(b - a == rows for a, b in mine[:-1])
        assert 0 < mine[-1][1] - mine[-1][0] <= rows
        taken += mine
    # every row exactly once, in order
    assert [r for a, b in taken for r in range(a, b)] == list(range(shape[0]))
    assert len(taken) == chunks


@pytest.mark.parametrize("shape, itemsize", [
    ((2, 8192, 8193), 4), ((0, 5), 4), ((), 4)],
    ids=["row_over_a_staging_block", "no_rows", "scalar"])
def test_blocks_whose_rows_do_not_stage_have_no_plan(shape, itemsize):
    assert transport.upload_plan(shape, itemsize, 8) == []


def _stubbed(monkeypatch, stage_bytes, upload_bytes=16, fits=True,
             pin_raises=False, cached=False, cpus=64):
    """Run the staged hand-off on the CPU: page-locked allocations are
    plain host tensors (their shapes recorded), the allocator's counters
    stubbed (``cached``: no allocation counts as new), ``pin_fits``
    answering ``fits``, a ``pin_raises`` allocation raising as on a host
    with no page-locked memory left, the host ``cpus`` CPUs.  Returns
    the list of staging shapes taken."""
    empty, taken = torch.empty, []
    count = {"n": 0}

    def pinned(*args, pin_memory=False, **kwargs):
        if pin_memory:
            if pin_raises:
                raise RuntimeError("no page-locked memory")
            taken.append(tuple(args[0]))
            count["n"] += 0 if cached else 1
        return empty(*args, **kwargs)

    monkeypatch.setattr(transport, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(transport, "UPLOAD_BYTES", upload_bytes)
    monkeypatch.setattr(transport.os, "cpu_count", lambda: cpus)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {
        "allocated_bytes.current": 0, "num_host_alloc": count["n"]})
    monkeypatch.setattr(transport, "pin_fits", lambda *a: fits)
    monkeypatch.setattr(torch, "empty", pinned)
    return taken


CPU = torch.device("cpu")

# (shape, dtype, stage bytes, cpus, lanes, chunks)
UPLOADS = {
    # 8 lanes of 4 rows (3 for the last), 2 rows of 48 B a chunk
    "eight_lanes_two_chunks": ((31, 3, 4), np.float32, 96, 64, 8, 16),
    # as many lanes as CPUs: 3 runs of 5, 4, 4 rows, one chunk each
    "three_cpus": ((13, 6), np.uint16, 60, 3, 3, 3),
    # 17 rows a chunk: runs of 226 and 225 rows, 14 chunks each
    "odd_uint16": ((1801, 3, 5), np.uint16, 512, 64, 8, 112),
}


@pytest.mark.parametrize("case", UPLOADS)
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_staged_upload_equals_the_plain_copy(monkeypatch, rng, case,
                                             as_tensor):
    shape, dtype, stage, cpus, lanes, chunks = UPLOADS[case]
    a = (rng.normal(size=shape) * 1000).astype(dtype)
    src = transport._host_array(torch.from_numpy(a.copy()) if as_tensor
                                else a)
    taken = _stubbed(monkeypatch, stage, cpus=cpus)
    (out,), reused, n = transport._stage_to([src], [CPU])
    assert out.dtype == torch.from_numpy(a).dtype and out.shape == shape
    assert out.numpy().tobytes() == a.tobytes()
    assert (reused, n) == (False, chunks)
    plan = transport.upload_plan(shape, a.itemsize, min(8, cpus))
    assert len(plan) == lanes
    # a ring of two staging blocks a lane, one for a lane of one chunk
    want = []
    for lo, hi in plan:
        r = transport.stage_rows((hi - lo, *shape[1:]), a.itemsize)
        want += [(r, *shape[1:])] * (2 if hi - lo > r else 1)
    assert taken == want
    assert all(np.prod(s) * a.itemsize <= stage for s in taken)


def test_a_strided_source_stages_its_rows(monkeypatch, rng):
    wide = rng.normal(size=(40, 6, 9)).astype(np.float32)
    a = wide[:, 1:5, ::2]
    assert not a.flags.c_contiguous
    _stubbed(monkeypatch, 96)
    (out,), _, n = transport._stage_to([a], [CPU])
    assert out.is_contiguous() and n == 40
    np.testing.assert_array_equal(out.numpy(), a)


def test_staging_blocks_from_the_cache_say_reused(monkeypatch, rng):
    a = rng.normal(size=(20, 4)).astype(np.float32)
    _stubbed(monkeypatch, 32, cached=True)
    (out,), reused, n = transport._stage_to([a], [CPU])
    np.testing.assert_array_equal(out.numpy(), a)
    # 8 lanes of 3, 3, 3, 3, 2, 2, 2, 2 rows at 2 rows a chunk
    assert reused is True and n == 12


@pytest.mark.parametrize("fits, pin_raises, case", [
    (False, False, "whole"), (True, True, "whole"), (True, False, "small"),
    (True, False, "row_over_a_block")],
    ids=["cap_refuses", "allocation_raises", "under_upload_bytes",
         "row_over_a_block"])
def test_a_source_that_cannot_stage_is_not_staged(monkeypatch, rng, fits,
                                                  pin_raises, case):
    a = rng.normal(size=(16, 4)).astype(np.float32)     # 256 B
    src = {"whole": a, "small": a[:3], "row_over_a_block": a.reshape(2, -1)
           }[case]
    taken = _stubbed(monkeypatch, 64, upload_bytes=64, fits=fits,
                     pin_raises=pin_raises)
    assert transport._stage_to([src], [CPU]) is None
    assert taken == []


@pytest.mark.parametrize("src, host", [
    ("numpy", True), ("pageable_tensor", True), ("bfloat16", False),
    ("pinned", False), ("sharded", False)])
def test_what_counts_as_a_pageable_host_source(monkeypatch, src, host):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(a)
    if src == "pinned":
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    source = {"numpy": a, "pageable_tensor": t,
              "bfloat16": t.to(torch.bfloat16), "pinned": t,
              "sharded": ShardedTransport(("cpu",) * 2)._scatter(
                  a, 0, "d")}[src]
    got = transport._host_array(source)
    assert (got is not None) is host
    if host:
        np.testing.assert_array_equal(got, a)


def test_a_copy_to_a_cpu_device_keeps_its_span():
    # on a CPU transport a source over UPLOAD_BYTES is not staged, and
    # the span has none of the staging attributes
    a = np.arange(80 << 20, dtype=np.uint8).reshape(1 << 10, -1)
    assert a.nbytes > transport.UPLOAD_BYTES
    ds = DataSet("tomo", a.shape, a.dtype, ("a", "b"), backing=a,
                 trace=Trace())
    t = CudaTransport("cpu")._to_device(ds, a)
    assert t.numpy().tobytes() == a.tobytes()
    (span,) = ds.trace.spans()
    assert span.attrs == {"bytes": a.nbytes, "dataset": "tomo",
                          "device": "cpu", "pinned": False}


@pytest.mark.parametrize("dim, k, cpus", [(0, 4, 8), (0, 4, 64), (1, 3, 8),
                                          (None, 2, 8), (0, 8, 4)],
                         ids=["451_450_450_450", "451_450_450_450_64_cpus",
                              "split_dim_1", "replicated",
                              "more_slots_than_cpus"])
def test_staged_slot_blocks_equal_the_slot_after_slot_copy(monkeypatch, rng,
                                                           dim, k, cpus):
    """Every slot's block fed at once, the lanes dealt over the slots
    (one at least each), through staging blocks: bit for bit the slot
    blocks of the plain scatter."""
    a = (rng.normal(size=(1801, 7, 3)) * 1000).astype(np.uint16)
    tr = ShardedTransport(("cpu",) * k)
    old = tr._scatter(a, dim, "tomo")
    taken = _stubbed(monkeypatch, 600, cpus=cpus)
    blocks = ([a] * k if dim is None else
              [transport._narrow(a, dim, lo, hi - lo)
               for lo, hi in tr._slot_bounds("tomo", a.shape, dim)])
    shards, reused, chunks = transport._stage_to(blocks, tr.slots)
    assert [tuple(s.shape) for s in shards] == \
        [tuple(t.shape) for t in old.shards]
    for s, t in zip(shards, old.shards):
        assert s.numpy().tobytes() == t.numpy().tobytes()
    lanes = max(1, min(8, cpus) // k)
    plans = [transport.upload_plan(b.shape, 2, lanes) for b in blocks]
    assert all(len(p) == lanes for p in plans)
    assert chunks == sum(len(transport.stage_chunks(
        hi - lo, transport.stage_rows((hi - lo, *b.shape[1:]), 2)))
        for b, p in zip(blocks, plans) for lo, hi in p)
    assert len(taken) == 2 * lanes * k and reused is False
    assert all(np.prod(s) * 2 <= 600 for s in taken)


# -- on the card ---------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _upload(dev, src):
    """``CudaTransport._to_device`` of ``src`` on a traced dataset: the
    tensor and the ``transport.to_device`` span."""
    ds = DataSet("tomo", tuple(src.shape), np.uint16, ("a", "b", "c"),
                 backing=src, trace=Trace())
    out = CudaTransport(dev)._to_device(ds, src)
    (span,) = [s for s in ds.trace.spans() if s.name == "transport.to_device"]
    return out, span


def _band(shape, dtype=np.uint16, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == np.uint16:
        return rng.integers(0, 65536, size=shape, dtype=np.uint16)
    return rng.random(shape, dtype=dtype)


def _chunks(shape, itemsize, lanes):
    """The chunks a staged hand-off of a block of ``shape`` takes at
    ``lanes`` lanes."""
    return sum(len(transport.stage_chunks(hi - lo, transport.stage_rows(
        (hi - lo, *shape[1:]), itemsize)))
        for lo, hi in transport.upload_plan(shape, itemsize, lanes))


def _lanes(slots=1):
    return max(1, min(transport.UPLOAD_LANES, os.cpu_count() or 1) // slots)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band", "odd_ragged", "cpu_tensor"])
def test_staged_upload_on_the_card_equals_the_pageable_copy(card, case,
                                                            monkeypatch):
    """A band in a staging block a lane; an odd float32 block (74.3 MB)
    through 1 MiB staging blocks (a ring of two a lane, a ragged last
    chunk);
    a pageable CPU tensor.  The second upload takes every staging block
    from the caching host allocator."""
    shape, dtype = {"band": (BAND, np.uint16),
                    "odd_ragged": ((3001, 6, 1031), np.float32),
                    "cpu_tensor": (BAND, np.uint16)}[case]
    if case == "odd_ragged":
        monkeypatch.setattr(transport, "STAGE_BYTES", MiB)
    a = _band(shape, dtype)
    src = torch.from_numpy(a) if case == "cpu_tensor" else a
    want = torch.from_numpy(a).to(card)
    out, span = _upload(card, src)
    # a kernel on the caller's stream reads the copy without a sync
    assert torch.equal(out, want)
    chunks = _chunks(shape, a.itemsize, _lanes())
    assert span.attrs["staged"] is True and span.attrs["pinned"] is False
    assert span.attrs["chunks"] == chunks
    assert chunks > _lanes() if case == "odd_ragged" else chunks == _lanes()
    assert span.attrs["bytes"] == a.nbytes
    _, again = _upload(card, src)
    assert again.attrs["staged"] is True and again.attrs["reused"] is True


@pytest.mark.gpu
def test_a_small_array_takes_the_plain_copy_on_the_card(card):
    # a sweep member's 4-row band, 36.9 MB: under UPLOAD_BYTES
    a = _band((1801, 4, 2560))
    out, span = _upload(card, a)
    assert torch.equal(out, torch.from_numpy(a).to(card))
    assert (span.attrs["staged"], span.attrs["reused"],
            span.attrs["chunks"]) == (False, False, 0)


@pytest.mark.gpu
def test_staged_scatter_over_four_slots_of_one_card(card, monkeypatch):
    """As ``chip_smoke.py`` phase 11: four slots of the card, 1801
    projections split 451/450/450/450 (88.5 MB in all), 1 MiB staging
    blocks (21 rows of 24 x 1024 uint16 a chunk); bit for bit the
    slot-after-slot copy."""
    monkeypatch.setattr(transport, "STAGE_BYTES", MiB)
    slots = transport.slots_on("cuda", 4)
    tr = ShardedTransport(slots)
    a = _band((1801, 24, 1024))
    ds = DataSet("tomo", a.shape, np.uint16, ("a", "b", "c"), backing=a,
                 trace=Trace())
    st = tr._scatter(a, 0, "tomo", ds)
    assert [t.shape[0] for t in st.shards] == [451, 450, 450, 450]
    for t, lo, hi in zip(st.shards, (0, 451, 901, 1351),
                         (451, 901, 1351, 1801)):
        assert torch.equal(t, torch.from_numpy(a[lo:hi]).to(card))
    (span,) = ds.trace.spans()
    assert span.attrs["staged"] is True and span.attrs["slots"] == 4
    assert span.attrs["bytes"] == a.nbytes
    assert span.attrs["chunks"] == sum(
        _chunks(t.shape, 2, _lanes(4)) for t in st.shards) >= 22 * 4
