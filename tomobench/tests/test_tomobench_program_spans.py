"""The readers of the program's copy spans (``tomobench.copies``): their
arithmetic on hand-made records, a traced run of the tiny one-card cells
in which each reads a number, and the committed spec that lists them."""
from __future__ import annotations

import pytest

from tomobench import bench
from tomobench.record import Record, Request, Span

from .tiny import REPO, run_cell

RATES = ("transport.to_host_gbps", "transport.to_device_gbps")
NEW = [f"{m}.{c}" for m in RATES + ("runner.host_pct",)
       for c in ("chain", "service")]


def read(name, rec):
    return bench.reader(name).read(rec)


def copy(name, start, end, nbytes):
    return Span(f"transport.{name}", start, end, {"bytes": nbytes})


def record(*spans, start=0.0, end=10.0, ok=True):
    return Record("c", 1, start, end,
                  [Request(0, start, start, end, ok, 16 if ok else 0,
                           list(spans))])


def test_rates_are_bytes_over_summed_walls():
    rec = record(copy("to_host", 6.0, 8.0, 4e9),
                 copy("to_host", 8.5, 9.0, 1e9),
                 copy("to_device", 0.5, 1.0, 3e9))
    for cell in ("chain", "service"):
        assert read(f"transport.to_host_gbps.{cell}", rec) == \
            pytest.approx(5e9 / 2.5 / 1e9)
        assert read(f"transport.to_device_gbps.{cell}", rec) == \
            pytest.approx(6.0)


def test_failed_requests_and_records_without_copies_read_nothing():
    steps = Span("plugin.fbp_recon.process", 1.0, 2.0)
    for rec in (record(steps), record(copy("to_host", 1, 2, 8),
                                      copy("to_device", 0, 1, 8), ok=False)):
        for name in NEW:
            assert read(name, rec) is None, name


def test_a_gangs_repeated_spans_count_once():
    shared = copy("to_device", 1.0, 2.0, 2e9)
    rec = record(shared, shared, copy("to_device", 2.0, 3.0, 2e9),
                 copy("to_host", 4.0, 5.0, 1e9))
    assert read("transport.to_device_gbps.chain", rec) == pytest.approx(2.0)
    # the same interval with other bytes is another copy
    rec = record(copy("to_device", 1.0, 2.0, 2e9),
                 copy("to_device", 1.0, 2.0, 1e9))
    assert read("transport.to_device_gbps.chain", rec) == pytest.approx(1.5)


def test_host_share_leaves_out_steps_and_copies():
    spans = [Span("runner.prepare", 0.0, 1.0),
             Span("plugin.a.setup", 0.2, 0.8),
             copy("to_device", 1.0, 2.0, 1),
             Span("plugin.a.process", 1.5, 4.0),
             Span("plugin.b.process", 4.5, 5.0),
             copy("to_host", 6.0, 9.0, 1),
             Span("queue.wait", 0.0, 10.0)]
    rec = record(*spans)
    # covered: [1, 4], [4.5, 5], [6, 9] = 6.5 of 10 s
    for cell in ("chain", "service"):
        assert read(f"runner.host_pct.{cell}", rec) == pytest.approx(35.0)
        assert read(f"runner.outside_steps_pct.{cell}", rec) == \
            pytest.approx(70.0)
    # a copy that outlasts its request is clipped to it
    rec = record(copy("to_host", 8.0, 12.0, 1))
    assert read("runner.host_pct.chain", rec) == pytest.approx(80.0)


def test_host_share_is_at_most_the_outside_steps_share():
    spans = [Span("plugin.a.process", 1.0, 3.0),
             copy("to_device", 0.5, 1.5, 1), copy("to_host", 2.5, 3.5, 1)]
    rec = record(*spans, end=4.0)
    host = read("runner.host_pct.chain", rec)
    outside = read("runner.outside_steps_pct.chain", rec)
    assert host == pytest.approx(25.0) and host < outside


@pytest.mark.parametrize("cell, seconds, twin", [
    ("tiny-band", 1.0, "chain"), ("tiny-sweep", 1.5, "service")])
def test_a_traced_run_reads_every_new_metric(tiny_root, cell, seconds, twin):
    r = run_cell(tiny_root, cell, 2**32 + 41, seconds, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True and res["failed"] == 0
    metrics = res["metrics"]
    for m in RATES:
        assert metrics[f"{m}.{twin}"]["value"] > 0
        assert metrics[f"{m}.{twin}"]["unit"] == "GB/s"
    host = metrics[f"runner.host_pct.{twin}"]["value"]
    assert 0 <= host <= metrics[f"runner.outside_steps_pct.{twin}"]["value"]


def test_the_committed_spec_lists_each_in_its_cell():
    spec = bench.load_spec(REPO)
    assert bench.validate(spec, REPO) == []
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "slices_per_s"
        assert m["layer"] == ("Runner and transport: PluginRunner, "
                              "CudaTransport, ShardedTransport")
        assert m["workloads"] == ["chain-band16" if name.endswith(".chain")
                                  else "tune-sweep4-over"]
        assert callable(bench.reader(name).read)
