"""The reader of the ``staged`` attribute of the program's
``transport.to_host`` spans (``transport.to_host_staged_pct.phase``):
its arithmetic on hand-made records, None for a program whose spans
lack the attribute (one that reads every volume into a page-locked
block or by one pageable copy, and any read on the CPU), and the
committed spec that lists it."""
from __future__ import annotations

import pytest

from tomobench import bench
from tomobench.record import Record, Request, Span

from .tiny import REPO

NAME = "transport.to_host_staged_pct.phase"


def read(rec):
    return bench.reader(NAME).read(rec)


def to_host(start, nbytes, **attrs):
    return Span("transport.to_host", start, start + 0.5,
                {"bytes": nbytes, "dataset": "recon", "device": "cuda:0",
                 "pinned": False, "reused": False, **attrs})


def request(index, *spans, ok=True):
    return Request(index, 0.0, 0.0, 10.0, ok, 720 if ok else 0, list(spans))


def record(*requests):
    return Record("c", 1, 0.0, 10.0, list(requests))


def test_the_share_is_of_bytes_not_of_reads():
    rec = record(
        request(0, to_host(1.0, 3e9, staged=True, chunks=72, lanes=8),
                to_host(2.0, 1e9, staged=False, pinned=True)),
        request(1, to_host(3.0, 4e9, staged=True, reused=True, chunks=72,
                           lanes=8),
                to_host(4.0, 2e9, staged=False)))
    assert read(rec) == pytest.approx(100.0 * 7e9 / 10e9)


def test_a_record_without_the_attribute_reads_nothing():
    # the parent's spans: no ``staged``
    assert read(record(request(0, to_host(1.0, 4e9)),
                       request(1, to_host(2.0, 4e9, pinned=True)))) is None
    assert read(record(request(0, Span("plugin.a.process", 0, 1)))) is None
    # the marked spans of a failed request are left out with it
    failed = record(request(0, to_host(1.0, 4e9, staged=True), ok=False),
                    request(1, to_host(2.0, 4e9)))
    assert read(failed) is None


def test_a_repeated_span_counts_once():
    hit = to_host(1.0, 1e9, staged=True)
    rec = record(request(0, hit, hit, to_host(2.0, 1e9, staged=False)))
    assert read(rec) == pytest.approx(50.0)


def test_the_committed_spec_lists_it_in_its_cell():
    spec = bench.load_spec(REPO)
    assert bench.validate(spec, REPO) == []
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == \
        ("%", "higher", "program_span", "slices_per_s")
    assert m["layer"] == ("Runner and transport: PluginRunner, "
                          "CudaTransport, ShardedTransport")
    assert m["workloads"] == ["chain-paganin-roi720"]
    assert spec["per_layer"][-1] is m
