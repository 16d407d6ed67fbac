"""The whole scan over four cards (``mpi4-scan-2160``): its files found
by name, its six per-layer readers on hand-made records, and a tiny
uneven version of the cell run end to end on four CPU slots with the
cell's own driver and traffic mix."""
from __future__ import annotations

import json

import pytest

from tomobench import bench, yardsticks
from tomobench.record import DeviceSummary, Record, Request, Span

from .tiny import LIMIT, REPO, make_root, run_cell

CELL = "mpi4-scan-2160"
NEW = ("transport.alltoall_gbps.mpi4", "transport.to_host_gbps.mpi4",
       "transport.to_device_gbps.mpi4", "device.idle_pct.mpi4",
       "backproject_roofline.mpi4", "runner.host_pct.mpi4")


def read(name, rec):
    return bench.reader(name).read(rec)


def test_the_new_spec_validates():
    assert bench.validate(bench.load_spec(REPO), REPO) == []


def test_the_cell_finds_its_files_by_name():
    spec = bench.load_spec(REPO)
    c = bench.cell(spec, REPO, CELL)
    assert c.chips == 4 and c.config["chips"] == 4
    assert c.config["name"] == "pco-edge-2560x2160-mpi4"
    assert (c.config["n_det"], c.config["n_rows"], c.config["n_angles"]) \
        == (2560, 2160, 1801) and c.config["reduced"] == []
    assert c.config["transport"] == {"kind": "sharded", "slots": "all",
                                     "expect": 4}
    assert c.traffic["kind"] == "closed_sharded"
    assert c.traffic["check"] == {"requests": 2, "slices_per_slot": 1}
    assert bench.driver(c.traffic["kind"]).DRIVER
    assert 0 < c.limits["recon_max_rel_err"]["limit"] < 1
    assert {m["name"] for m in c.end_to_end()} == {"slices_per_s",
                                                   "setup_s"}
    assert {m["name"] for m in c.per_layer()} == set(NEW)
    one = json.loads((REPO / "tomobench" / "configs" /
                      "pco-edge-2560x1801.json").read_text())
    assert c.config["process_list"] == one["process_list"]


def _record(spans=(), device=None, work=None):
    r = Request(0, 0.0, 0.0, 10.0, True, 2160, list(spans), work or {})
    return Record(CELL, 4, 0.0, 10.0, [r], device=device)


def test_the_readers_read_their_spans():
    spans = [Span("transport.alltoall", 1.0, 1.5, {"bytes": 3_000_000_000}),
             Span("transport.to_device", 0.0, 2.0, {"bytes": 8_000_000_000}),
             Span("transport.to_host", 5.0, 9.0, {"bytes": 20_000_000_000}),
             Span("transport.to_host", 5.0, 9.0, {"bytes": 20_000_000_000})]
    rec = _record(spans, DeviceSummary([2.0, 4.0, 6.0, 8.0], 10.0, [], []))
    assert read("transport.alltoall_gbps.mpi4", rec) == pytest.approx(6.0)
    assert read("transport.to_device_gbps.mpi4", rec) == pytest.approx(4.0)
    # one span a request carries twice counts once
    assert read("transport.to_host_gbps.mpi4", rec) == pytest.approx(5.0)
    assert read("device.idle_pct.mpi4", rec) == pytest.approx(50.0)
    # neither a step nor a copy covers [2, 5) and [9, 10) of the wall
    assert read("runner.host_pct.mpi4", rec) == pytest.approx(40.0)


def test_the_roofline_reads_the_whole_scans_step_on_four_cards():
    work = {"fbp": [{"slices": 2160, "angles": 1801, "n_det": 2560,
                     "out_size": 2560}]}
    rec = _record([Span("plugin.fbp_recon.process", 3.0, 5.0)], work=work)
    least = yardsticks.least_seconds(
        yardsticks.backprojection(2160, 1801, 2560, 2560), 4)
    assert read("backproject_roofline.mpi4", rec) == \
        pytest.approx(100.0 * least / 2.0)


@pytest.mark.parametrize("name", NEW)
def test_a_record_without_their_spans_reads_nothing(name):
    assert read(name, _record([Span("plugin.fbp_recon.process", 1, 2)])) \
        is None


@pytest.fixture(scope="module")
def uneven_root(tmp_path_factory):
    """A checkout with ``tiny-mpi-scan``: 61 angles and 15 rows over 4
    CPU slots (16/15/15/15 and 4/4/4/3), the cell's own traffic mix, and
    the cell's metrics listing it."""
    root = make_root(tmp_path_factory.mktemp("uneven"))
    pkg = root / "tomobench"
    conf = json.loads((pkg / "configs" / "tiny-64-mpi.json").read_text())
    conf.update(name="tiny-61-mpi", n_angles=61, n_rows=15)
    (pkg / "configs" / "tiny-61-mpi.json").write_text(json.dumps(conf))
    (pkg / "limits" / "tiny-mpi-scan.json").write_text(json.dumps(
        {"recon_max_rel_err": {"limit": LIMIT}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-61-mpi", "source": "tiny",
                            "file": "tomobench/configs/tiny-61-mpi.json",
                            "reduced": ["n_det", "n_rows", "n_angles"],
                            "why": "CPU tests"})
    spec["workloads"].append({"name": "tiny-mpi-scan",
                              "config": "tiny-61-mpi",
                              "traffic": "scan-mpi4", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-mpi-scan")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_an_uneven_scan_runs_correct_and_reads_its_all_to_all(uneven_root):
    r = run_cell(uneven_root, "tiny-mpi-scan", 2**33 + 5, 0.5,
                 trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    m = res["metrics"]
    for name in NEW[:3]:
        assert m[name]["value"] > 0 and m[name]["unit"] == "GB/s"
    for name in NEW[4:]:
        assert 0 < m[name]["value"] <= 100 and m[name]["unit"] == "%"
    assert res["checks"]["recon_max_rel_err"]["value"] <= LIMIT
