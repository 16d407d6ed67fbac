"""``BENCHMARK.json`` keeps the rules, and every name in it finds its
files."""
from __future__ import annotations

import copy
import json

import pytest

from tomobench import bench

from .tiny import REPO


@pytest.fixture
def spec():
    return bench.load_spec(REPO)


def test_benchmark_json_validates(spec):
    assert bench.validate(spec, REPO) == []


def test_every_name_finds_its_files(spec):
    for w in spec["workloads"]:
        c = bench.cell(spec, REPO, w["name"])
        assert bench.driver(c.traffic["kind"]).DRIVER
        assert c.limits["recon_max_rel_err"]["limit"] > 0
        assert c.config["chips"] == w["chips"]
        for m in c.end_to_end() + c.per_layer():
            assert callable(bench.reader(m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    for w in spec["workloads"]:
        c = bench.cell(spec, REPO, w["name"])
        e2e = {m["name"] for m in c.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer()
        for m in c.per_layer():
            assert m["moves"] in e2e


@pytest.mark.parametrize("bad, needle", [
    ({"name": "two words"}, "not a name"),
    ({"unit": "tokens per second"}, "unit"),
    ({"bound": 0.3}, "bound"),
    ({"source": "program_span"}, "end-to-end source"),
])
def test_bad_end_to_end_metric_is_refused(spec, bad, needle):
    s = copy.deepcopy(spec)
    s["end_to_end"][0].update(bad)
    assert any(needle in e for e in bench.validate(s, REPO))


def test_a_per_layer_metric_must_move_what_its_cells_report(spec):
    s = copy.deepcopy(spec)
    e2e = next(m for m in s["end_to_end"] if m["name"] == "slices_per_s")
    e2e["workloads"] = ["chain-band16"]
    errors = bench.validate(s, REPO)
    assert any("service.queue_wait_p95_s moves slices_per_s, which "
               "tune-sweep4-over does not report" in e for e in errors)


def test_four_chip_cells_at_most_a_quarter_one_always(spec):
    s = copy.deepcopy(spec)
    assert len(s["workloads"]) == 2
    s["workloads"][0]["chips"] = 4                  # 1 of 2: allowed
    assert bench.validate(s, REPO) == []
    s["workloads"][1]["chips"] = 4                  # 2 of 2: refused
    assert any("on 4 chips" in e for e in bench.validate(s, REPO))
    extra = [dict(s["workloads"][1], name=f"x{i}", traffic=f"t{i}",
                  chips=1) for i in range(6)]
    s["workloads"] += extra[:5]                     # 2 of 7: refused
    assert any("on 4 chips" in e for e in bench.validate(s, REPO))
    s["workloads"] += extra[5:]
    # 2 of 8: 25 % of 8 is 2, allowed
    assert not any("on 4 chips" in e for e in bench.validate(s, REPO))


def test_names_units_and_files_of_the_committed_spec(spec):
    text = json.dumps(spec)
    assert len(text) <= 64 * 1024
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert bench.NAME.match(m["name"]) and bench.UNIT.match(m["unit"])
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
