"""The read of a volume off one card whose page-locked destination is
refused (``core.transport._read_off_card``'s staged branch,
``_read_staged``): its rows dealt over lanes, each lane draining its run
through its own page-locked staging blocks into its own view of one
fresh pageable array.

On the CPU: a CPU tensor stands for the card's, page-locked allocations
are plain host tensors (their shapes recorded) and the allocator's
counters are stubbed, so ``_drain`` takes its host branch; the read
equals ``b.cpu().numpy()`` bit for bit and takes every row once, its
span says what was staged, and a destination that fits or staging
blocks that cannot be had keep the other branches.  On the card
(``gpu`` marker, skipped without a CUDA device): a 1.5 GB volume whose
page-locked block the cap refuses reads bit for bit, takes its staging
blocks from the allocator's cache the second time, and pins no more
than its staging blocks.  The file imports neither jax nor the JAX
package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_staged_read.py
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import CudaTransport, DataSet, transport
from repro_torch.obs import Trace

MiB = 1 << 20
GiB = 1 << 30


def _stubbed(monkeypatch, stage_bytes, cpus, fits=True, whole_fits=False,
             pin_raises=False, cached=False):
    """Page-locked allocations as plain host tensors (their shapes
    recorded), the allocator's counters stubbed (``cached``: no
    allocation counts as new), the host ``cpus`` CPUs, ``pin_fits``
    answering ``whole_fits`` for its first request (the whole
    destination's block) and ``fits`` after, a ``pin_raises`` allocation
    raising as on a host with no page-locked memory left.  Returns the
    staging shapes taken and the bytes ``pin_fits`` was asked for."""
    empty, taken, asked = torch.empty, [], []
    count = {"n": 0}

    def pinned(*args, pin_memory=False, **kwargs):
        if pin_memory:
            if pin_raises:
                raise RuntimeError("no page-locked memory")
            taken.append(tuple(args[0]))
            count["n"] += 0 if cached else 1
        return empty(*args, **kwargs)

    def pin_fits(owned, nbytes, phys):
        asked.append(nbytes)
        return whole_fits if len(asked) == 1 else fits

    monkeypatch.setattr(transport, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(transport.os, "cpu_count", lambda: cpus)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {
        "allocated_bytes.current": 0, "num_host_alloc": count["n"]})
    monkeypatch.setattr(transport, "pin_fits", pin_fits)
    monkeypatch.setattr(torch, "empty", pinned)
    return taken, asked


def _volume(rng, shape, dtype):
    if np.dtype(dtype).kind == "u":
        return rng.integers(0, 65536, size=shape).astype(dtype)
    return (rng.normal(size=shape) * 1000).astype(dtype)


def _read(b):
    """``_read_off_card`` of ``b`` on a traced dataset: the array and
    the ``transport.to_host`` span."""
    ds = DataSet("recon", tuple(b.shape), b.numpy().dtype, ("z", "y", "x"),
                 backing=b, trace=Trace())
    out = transport._read_off_card(ds, b)
    (span,) = ds.trace.spans()
    assert span.name == "transport.to_host"
    return out, span


def _plan(shape, itemsize, lanes):
    """Each lane's run, its rows a chunk and its chunks, as the staged
    read takes them."""
    out = []
    for lo, hi in transport.upload_plan(shape, itemsize, lanes):
        rows = transport.stage_rows((hi - lo, *shape[1:]), itemsize)
        out.append((lo, hi, rows, len(transport.stage_chunks(hi - lo, rows))))
    return out


# (shape, dtype, stage bytes, cpus, lanes, chunks)
READS = {
    # 8 lanes of 4 rows, 2 rows of 48 B a chunk
    "eight_lanes_even": ((32, 3, 4), np.float32, 96, 8, 8, 16),
    # runs of 7 and 6 rows, 3 rows of 60 B a chunk: 3 + 2 chunks, the
    # first lane's last chunk ragged
    "two_lanes_ragged": ((13, 3, 5), np.float32, 180, 2, 2, 5),
    # one lane, 3 rows of 8 B a chunk, the last chunk one row
    "one_lane_uint16": ((10, 2, 2), np.uint16, 24, 1, 1, 4),
    # the whole volume one chunk of one lane: one staging block
    "one_chunk": ((6, 5, 1), np.float32, 4096, 1, 1, 1),
    # fewer rows than lanes: a lane a row
    "fewer_rows_than_lanes": ((3, 7, 2), np.uint16, 64, 8, 3, 3),
    # 17 rows of 30 B a chunk, runs of 226 and 225 rows: 14 chunks each
    "eight_lanes_1801_uint16": ((1801, 3, 5), np.uint16, 512, 8, 8, 112),
}


@pytest.mark.parametrize("case", READS)
def test_staged_read_equals_the_pageable_copy(monkeypatch, rng, case):
    shape, dtype, stage, cpus, lanes, chunks = READS[case]
    a = _volume(rng, shape, dtype)
    b = torch.from_numpy(a.copy())
    want = b.cpu().numpy()
    taken, asked = _stubbed(monkeypatch, stage, cpus)
    got, span = _read(b)
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    assert got.tobytes() == want.tobytes() == a.tobytes()
    assert got.flags.c_contiguous and got.flags.writeable
    # the whole destination's page-locked block was asked for first
    assert asked[0] == transport.pinned_block_bytes(a.nbytes)
    plan = _plan(shape, a.itemsize, lanes)
    assert len(plan) == lanes and sum(p[3] for p in plan) == chunks
    # one staging block for a run of one chunk, a ring of two for more,
    # each of the run's chunk rows and at most a staging block's bytes
    assert taken == [(rows, *shape[1:]) for _, _, rows, n in plan
                     for _ in range(min(2, n))]
    assert all(np.prod(s) * a.itemsize <= stage for s in taken)
    assert span.attrs == {"bytes": a.nbytes, "dataset": "recon",
                          "device": "cpu", "pinned": False,
                          "reused": False, "staged": True,
                          "chunks": chunks, "lanes": lanes}


@pytest.mark.parametrize("case", ["eight_lanes_even", "two_lanes_ragged",
                                  "fewer_rows_than_lanes"])
def test_every_row_is_read_once(monkeypatch, rng, case):
    """The runs handed to the lanes cover the rows in order, each into
    the destination's rows of its own place, and drain every row."""
    shape, dtype, stage, cpus, lanes, chunks = READS[case]
    a = _volume(rng, shape, dtype)
    b = torch.from_numpy(a)
    _stubbed(monkeypatch, stage, cpus)
    row = int(np.prod(shape[1:]))
    runs, drain = [], transport._drain
    lock = threading.Lock()

    def recorded(block, dst, stages, stream):
        n = drain(block, dst, stages, stream)
        with lock:
            runs.append((block.storage_offset() // row, block.shape[0],
                         dst.storage_offset() // row, n))
        return n

    monkeypatch.setattr(transport, "_drain", recorded)
    got, span = _read(b)
    runs.sort()
    assert [r[0] for r in runs] == [lo for lo, *_ in _plan(shape, a.itemsize,
                                                           lanes)]
    # each run lands on the destination's rows of its own place
    assert all(src == dst for src, _, dst, _ in runs)
    taken = [r for lo, n, _, _ in runs for r in range(lo, lo + n)]
    assert taken == list(range(shape[0]))
    assert sum(r[3] for r in runs) == span.attrs["chunks"] == chunks
    assert got.tobytes() == a.tobytes()


def test_a_strided_volume_reads_in_its_own_order(monkeypatch, rng):
    a = _volume(rng, (9, 4, 6), np.float32)
    b = torch.from_numpy(a).transpose(1, 2)            # (9, 6, 4), strided
    _stubbed(monkeypatch, 4 * 24 * 2, 4)
    got, span = _read(b)
    assert got.tobytes() == np.ascontiguousarray(
        a.transpose(0, 2, 1)).tobytes()
    assert span.attrs["staged"] is True and span.attrs["lanes"] == 4


def test_staging_blocks_from_the_cache_say_reused(monkeypatch, rng):
    a = _volume(rng, (12, 2, 3), np.float32)
    _stubbed(monkeypatch, 48, 3, cached=True)
    got, span = _read(torch.from_numpy(a))
    assert got.tobytes() == a.tobytes()
    assert span.attrs["staged"] is True and span.attrs["reused"] is True
    assert span.attrs["pinned"] is False
    assert (span.attrs["chunks"], span.attrs["lanes"]) == (6, 3)


def test_a_destination_that_fits_takes_the_page_locked_block(monkeypatch,
                                                             rng):
    a = _volume(rng, (32, 3, 4), np.float32)
    taken, asked = _stubbed(monkeypatch, 96, 8, whole_fits=True)
    drained = []
    monkeypatch.setattr(transport, "_drain",
                        lambda *args: drained.append(args) or 0)
    got, span = _read(torch.from_numpy(a))
    assert got.tobytes() == a.tobytes()
    assert taken == [(32, 3, 4)] and len(asked) == 1 and drained == []
    assert span.attrs == {"bytes": a.nbytes, "dataset": "recon",
                          "device": "cpu", "pinned": True, "reused": False,
                          "staged": False}


@pytest.mark.parametrize("fits, pin_raises, stage", [
    (False, False, 96), (True, True, 96), (True, False, 40)],
    ids=["cap_refuses_the_staging_blocks", "allocation_raises",
         "row_over_a_staging_block"])
def test_a_read_that_cannot_stage_is_the_pageable_copy(monkeypatch, rng,
                                                      fits, pin_raises,
                                                      stage):
    a = _volume(rng, (13, 3, 4), np.float32)            # a row: 48 B
    taken, asked = _stubbed(monkeypatch, stage, 8, fits=fits,
                            pin_raises=pin_raises)
    got, span = _read(torch.from_numpy(a))
    assert got.tobytes() == a.tobytes()
    assert got.flags.c_contiguous and got.flags.writeable
    assert taken == []
    # a row over a staging block is refused before any allocation
    assert len(asked) == (1 if stage < 48 else 2)
    assert span.attrs == {"bytes": a.nbytes, "dataset": "recon",
                          "device": "cpu", "pinned": False,
                          "reused": False, "staged": False}


def test_concurrent_staged_reads_keep_their_own_rows(monkeypatch, rng):
    """Twelve reads at once from their own threads, on the one kept pool
    of lanes, with the interpreter switching threads often: each read
    equals its own volume."""
    vols = [_volume(rng, (29, 3, 2), np.float32) for _ in range(12)]
    _stubbed(monkeypatch, 24, 8)
    # each read's whole block (1 KiB) is refused, its sixteen 32 B
    # staging blocks fit
    monkeypatch.setattr(transport, "pin_fits",
                        lambda owned, nbytes, phys: nbytes < 29 * 24)
    got = [None] * len(vols)

    def read(i):
        got[i] = _read(torch.from_numpy(vols[i]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(i,))
                   for i in range(len(vols))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for a, (out, span) in zip(vols, got):
        assert out.tobytes() == a.tobytes()
        assert span.attrs["staged"] is True and span.attrs["lanes"] == 8
        assert span.attrs["chunks"] == 29


def test_the_benchmark_reads_the_staged_share_of_the_spans(monkeypatch,
                                                         rng):
    """``transport.to_host_staged_pct.phase`` over a staged read's span
    and a page-locked read's: the staged bytes' share; nothing over
    spans without ``staged``, as the program before it gives."""
    from tomobench import bench
    from tomobench.record import Record, Request, Span
    read = bench.reader("transport.to_host_staged_pct.phase").read
    big = _volume(rng, (24, 3, 4), np.float32)
    small = _volume(rng, (8, 3, 4), np.float32)
    _stubbed(monkeypatch, 96, 8)
    _, staged = _read(torch.from_numpy(big))
    monkeypatch.setattr(transport, "pin_fits", lambda *a: True)
    _, pinned = _read(torch.from_numpy(small))
    assert (staged.attrs["staged"], pinned.attrs["staged"]) == (True, False)

    def record(*spans):
        return Record("chain-paganin-roi720", 1, 0.0, 10.0,
                      [Request(0, 0.0, 0.0, 10.0, True, 720, list(spans))])

    assert read(record(staged, pinned)) == pytest.approx(
        100.0 * big.nbytes / (big.nbytes + small.nbytes))
    assert read(record(staged)) == pytest.approx(100.0)
    unmarked = [Span(s.name, s.start, s.end,
                     {k: v for k, v in s.attrs.items() if k != "staged"})
                for s in (staged, pinned)]
    assert read(record(*unmarked)) is None


# -- on the card ---------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _read_on_card(dev, t):
    ds = DataSet("recon", tuple(t.shape), np.float32, ("z", "y", "x"),
                 backing=t, trace=Trace())
    vol = CudaTransport(dev).read(ds)
    (span,) = [s for s in ds.trace.spans() if s.name == "transport.to_host"]
    return vol, span


@pytest.mark.gpu
def test_a_volume_over_the_cap_reads_staged_on_the_card(card, monkeypatch):
    """72 slices of 2560 x 2048 float32 (1.51 GB, a 2 GiB page-locked
    block) with the cap refusing any block over 1 GiB, through 32 MiB
    staging blocks (one slice a chunk, a ring of two a lane): bit for
    bit the card's ``.cpu()``; the second read takes every staging
    block from the allocator's cache; the page-locked bytes grow by at
    most two staging blocks a lane."""
    real = transport.pin_fits
    monkeypatch.setattr(transport, "pin_fits", lambda owned, nbytes, phys:
                        nbytes <= GiB and real(owned, nbytes, phys))
    monkeypatch.setattr(transport, "STAGE_BYTES", 32 * MiB)
    shape = (72, 2560, 2048)
    g = torch.Generator(device=card).manual_seed(5)
    t = torch.randn(shape, device=card, generator=g)
    want = t.cpu().numpy()
    lanes = min(transport.UPLOAD_LANES, os.cpu_count() or 1)
    chunks = sum(p[3] for p in _plan(shape, 4, lanes))
    before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    vol, span = _read_on_card(card, t)
    grown = torch.cuda.host_memory_stats()["allocated_bytes.current"] - before
    assert np.array_equal(vol.view(np.uint32), want.view(np.uint32))
    assert vol.flags.c_contiguous and vol.flags.writeable
    assert span.attrs["staged"] is True and span.attrs["pinned"] is False
    assert span.attrs["lanes"] == lanes and span.attrs["chunks"] == chunks
    assert chunks == 72 and span.attrs["bytes"] == vol.nbytes
    assert 0 <= grown <= 2 * lanes * transport.STAGE_BYTES
    del vol
    vol, again = _read_on_card(card, t)
    assert again.attrs["staged"] is True and again.attrs["reused"] is True
    assert np.array_equal(vol.view(np.uint32), want.view(np.uint32))
