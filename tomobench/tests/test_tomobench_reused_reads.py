"""The readers of the ``reused`` attribute of the program's
``transport.to_host`` spans (``tomobench.reuse``): their arithmetic on
hand-made records, None for a program whose spans lack the attribute
(one that reads into fresh pageable memory, and any read on the CPU),
and the committed spec that lists them."""
from __future__ import annotations

import pytest

from tomobench import bench
from tomobench.record import Record, Request, Span

from .tiny import REPO, run_cell

NAMES = ("transport.to_host_reused_pct.chain",
         "transport.to_host_reused_pct.service")


def read(name, rec):
    return bench.reader(name).read(rec)


def to_host(start, nbytes, **attrs):
    return Span("transport.to_host", start, start + 0.5,
                {"bytes": nbytes, "dataset": "recon", "device": "cuda:0",
                 **attrs})


def request(index, *spans, ok=True):
    return Request(index, 0.0, 0.0, 10.0, ok, 16 if ok else 0, list(spans))


def record(*requests):
    return Record("c", 1, 0.0, 10.0, list(requests))


@pytest.mark.parametrize("name", NAMES)
def test_the_share_is_of_bytes_not_of_reads(name):
    rec = record(
        request(0, to_host(1.0, 3e9, pinned=True, reused=True),
                to_host(2.0, 1e9, pinned=True, reused=False)),
        request(1, to_host(3.0, 4e9, pinned=True, reused=True),
                to_host(4.0, 2e9, pinned=False, reused=False)))
    assert read(name, rec) == pytest.approx(100.0 * 7e9 / 10e9)


@pytest.mark.parametrize("name", NAMES)
def test_a_record_without_the_attribute_reads_nothing(name):
    # reads into fresh pageable memory: pinned False, no ``reused``
    pageable = record(request(0, to_host(1.0, 4e9, pinned=False)),
                      request(1, to_host(2.0, 4e9, pinned=False)))
    assert read(name, pageable) is None
    assert read(name, record(request(0, Span("plugin.a.process", 0, 1)))) \
        is None
    # the marked spans of a failed request are left out with it
    failed = record(request(0, to_host(1.0, 4e9, pinned=True, reused=True),
                            ok=False),
                    request(1, to_host(2.0, 4e9, pinned=False)))
    assert read(name, failed) is None


def test_a_gangs_repeated_span_counts_once():
    hit = to_host(1.0, 1e9, pinned=True, reused=True)
    rec = record(request(0, hit, hit,
                         to_host(2.0, 1e9, pinned=True, reused=False)))
    assert read(NAMES[0], rec) == pytest.approx(50.0)


def test_a_traced_cpu_run_leaves_the_metric_out(tiny_root):
    # a CPU read takes no page-locked block and carries no ``reused``
    r = run_cell(tiny_root, "tiny-band", 2**32 + 97, 1.0, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True
    assert "transport.to_host_gbps.chain" in res["metrics"]
    assert not set(NAMES) & set(res["metrics"])


def test_the_committed_spec_lists_each_in_its_cell():
    spec = bench.load_spec(REPO)
    assert bench.validate(spec, REPO) == []
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert [m["name"] for m in spec["per_layer"][-2:]] == list(NAMES)
    for name in NAMES:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("%", "higher", "program_span", "slices_per_s")
        assert m["layer"] == ("Runner and transport: PluginRunner, "
                              "CudaTransport, ShardedTransport")
        assert m["workloads"] == ["chain-band16" if name.endswith(".chain")
                                  else "tune-sweep4-over"]
        assert callable(bench.reader(name).read)
