"""The readers of the ``staged`` attribute of the program's
``transport.to_device`` spans (``tomobench.staged``): their arithmetic
on hand-made records, None for a program whose spans lack the attribute
(one that copies pageable memory to the card, and any copy on the CPU),
and the committed spec that lists them."""
from __future__ import annotations

import pytest

from tomobench import bench
from tomobench.record import Record, Request, Span

from .tiny import REPO, run_cell

NAMES = ("transport.to_device_staged_pct.chain",
         "transport.to_device_staged_pct.mpi4")


def read(name, rec):
    return bench.reader(name).read(rec)


def to_device(start, nbytes, **attrs):
    return Span("transport.to_device", start, start + 0.5,
                {"bytes": nbytes, "dataset": "tomo", "device": "cuda:0",
                 "pinned": False, **attrs})


def request(index, *spans, ok=True):
    return Request(index, 0.0, 0.0, 10.0, ok, 16 if ok else 0, list(spans))


def record(*requests):
    return Record("c", 1, 0.0, 10.0, list(requests))


@pytest.mark.parametrize("name", NAMES)
def test_the_share_is_of_bytes_not_of_copies(name):
    rec = record(
        request(0, to_device(1.0, 3e9, staged=True, reused=True, chunks=40),
                to_device(2.0, 1e9, staged=False, reused=False, chunks=0)),
        request(1, to_device(3.0, 4e9, staged=True, reused=False, chunks=40),
                to_device(4.0, 2e9)))
    assert read(name, rec) == pytest.approx(100.0 * 7e9 / 10e9)


@pytest.mark.parametrize("name", NAMES)
def test_a_record_without_the_attribute_reads_nothing(name):
    # copies out of pageable memory: no ``staged``
    pageable = record(request(0, to_device(1.0, 4e9)),
                      request(1, to_device(2.0, 4e9)))
    assert read(name, pageable) is None
    assert read(name, record(request(0, Span("plugin.a.process", 0, 1)))) \
        is None
    # the marked spans of a failed request are left out with it
    failed = record(request(0, to_device(1.0, 4e9, staged=True), ok=False),
                    request(1, to_device(2.0, 4e9)))
    assert read(name, failed) is None


def test_a_gangs_repeated_span_counts_once():
    hit = to_device(1.0, 1e9, staged=True)
    rec = record(request(0, hit, hit, to_device(2.0, 1e9, staged=False)))
    assert read(NAMES[0], rec) == pytest.approx(50.0)


def test_a_traced_cpu_run_leaves_the_metric_out(tiny_root):
    # a copy to a CPU device is never staged and carries no ``staged``
    r = run_cell(tiny_root, "tiny-band", 2**32 + 131, 1.0, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True
    assert "transport.to_device_gbps.chain" in res["metrics"]
    assert not set(NAMES) & set(res["metrics"])


def test_the_committed_spec_lists_each_in_its_cell():
    spec = bench.load_spec(REPO)
    assert bench.validate(spec, REPO) == []
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("%", "higher", "program_span", "slices_per_s")
        assert m["layer"] == ("Runner and transport: PluginRunner, "
                              "CudaTransport, ShardedTransport")
        assert m["workloads"] == ["chain-band16" if name.endswith(".chain")
                                  else "mpi4-scan-2160"]
        assert callable(bench.reader(name).read)
