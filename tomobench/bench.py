"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<config>``: ``configs/<config>.json`` (its ``file``
  in ``BENCHMARK.json``);
* a traffic mix ``<traffic>``: ``traffic/<traffic>.json``, whose
  ``kind`` names its driver, ``drivers/<kind>.py``;
* a metric ``<name>``: the reader ``metrics/<name>.py``, whose
  ``read(record)`` returns the value or None (nothing to read);
* a cell's comparison limits: ``limits/<workload>.json``.

Adding a cell adds files and one ``workloads`` entry; no file that is
there changes.  :func:`validate` checks the spec against the rules the
benchmark keeps (names, units, sizes, which cells report what).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import re
from pathlib import Path
from types import ModuleType
from typing import Any

#: this package's directory
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@dataclasses.dataclass
class Cell:
    """One workload entry with its configuration and traffic loaded."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    spec: dict
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those with no list whose ``moves`` it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(spec: dict, root: Path, workload: str,
         base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``spec``: its configuration file (the
    spec's ``file``, relative to ``root``), its traffic mix
    (``<base>/traffic/<traffic>.json``) and its limits
    (``<base>/limits/<workload>.json``)."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = _json(Path(root) / configs[w["config"]]["file"])
    traffic = _json(Path(base) / "traffic" / f"{w['traffic']}.json")
    lim_path = Path(base) / "limits" / f"{workload}.json"
    limits = _json(lim_path) if lim_path.is_file() else {}
    return Cell(workload, w, conf, traffic, limits, spec, Path(root))


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE) -> ModuleType:
    """The reader of ``metric``: ``<base>/metrics/<metric>.py``."""
    path = Path(base) / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {metric!r} has no reader {path}")
    return _module(path, "tomobench_metric_" + re.sub(r"\W", "_", metric))


def driver(kind: str) -> ModuleType:
    """The driver of a traffic mix's ``kind``: ``drivers/<kind>.py``."""
    if not NAME.match(kind) or "." in kind:
        raise ValueError(f"bad driver kind {kind!r}")
    return importlib.import_module(f"tomobench.drivers.{kind}")


def read_metrics(metrics: list[dict], record, base: Path = HERE
                 ) -> dict[str, dict[str, Any]]:
    """Each metric's value from its reader, with its unit; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in metrics:
        v = reader(m["name"], base).read(record)
        if v is None:
            continue
        v = float(v)
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# ----------------------------------------------------------------------
def _line(s: Any, what: str, errors: list[str]) -> None:
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
            or "\t" in s:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def _name(s: Any, what: str, errors: list[str]) -> None:
    if not isinstance(s, str) or not NAME.match(s):
        errors.append(f"{what} {s!r}: not a name")


def validate(spec: dict, root: Path) -> list[str]:
    """Everything wrong with ``spec`` (empty when it keeps the rules)."""
    e: list[str] = []
    root = Path(root)
    if set(spec) != TOP_KEYS:
        e.append(f"keys {sorted(spec)} are not {sorted(TOP_KEYS)}")
        return e
    if len(json.dumps(spec)) > 64 * 1024:
        e.append("BENCHMARK.json over 64 KiB")
    paths = spec["paths"]
    if not 1 <= len(paths) <= 16:
        e.append("1 to 16 paths")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            e.append(f"path {p!r}")
    cmd = spec["command"]
    if not 1 <= len(cmd) <= 32:
        e.append("command: 1 to 32 words")
    for w in cmd:
        _line(w, "command word", e)
        if isinstance(w, str) and (w.startswith("/") or ".." in w):
            e.append(f"command word {w!r} leaves the checkout")
    rs = spec["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        e.append("run_seconds: a whole number from 1 to 51")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/")
                   for p in paths)

    configs = spec["configs"]
    if not 1 <= len(configs) <= 24:
        e.append("1 to 24 configs")
    files = set()
    for c in configs:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            e.append(f"config keys {sorted(c)}")
            continue
        _name(c["name"], "config", e)
        _line(c["source"], f"config {c['name']} source", e)
        _line(c["why"], f"config {c['name']} why", e)
        if not under_paths(c["file"]) or not (root / c["file"]).is_file():
            e.append(f"config file {c['file']} not under paths")
        if c["file"] in files:
            e.append(f"config file {c['file']} shared")
        files.add(c["file"])
        if len(c["reduced"]) > 16:
            e.append(f"config {c['name']}: reduced has over 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key", e)
            if k.endswith(("_dim", "_rank")):
                e.append(f"config {c['name']}: reduced names a width {k}")
    cnames = [c["name"] for c in configs]
    wl = spec["workloads"]
    if not 1 <= len(wl) <= 24:
        e.append("1 to 24 workloads")
    pairs = set()
    for w in wl:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            e.append(f"workload keys {sorted(w)}")
            continue
        _name(w["name"], "workload", e)
        _name(w["traffic"], "traffic", e)
        _line(w["why"], f"workload {w['name']} why", e)
        if w["config"] not in cnames:
            e.append(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            e.append(f"workload {w['name']}: chips 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            e.append(f"config and traffic of {w['name']} repeat")
        pairs.add((w["config"], w["traffic"]))
    four = sum(1 for w in wl if w.get("chips") == 4)
    if four > max(1, len(wl) * 25 // 100):
        e.append(f"{four} cells on 4 chips of {len(wl)}")
    used = {w.get("config") for w in wl}
    for c in cnames:
        if c not in used:
            e.append(f"config {c} used by no cell")
    wnames = [w["name"] for w in wl]
    metrics = spec["end_to_end"] + spec["per_layer"]
    if len(set(cnames)) != len(cnames) or len(set(wnames)) != len(wnames) \
            or len({m.get("name") for m in metrics}) != len(metrics):
        e.append("names repeat")
    if not 1 <= len(spec["end_to_end"]) <= 16:
        e.append("1 to 16 end-to-end metrics")
    if not 1 <= len(spec["per_layer"]) <= 128:
        e.append("1 to 128 per-layer metrics")
    e2e_of: dict[str, set[str]] = {w: set() for w in wnames}
    has_setup = False
    for m in spec["end_to_end"]:
        keys = {"name", "unit", "better", "bound", "source"}
        if not keys <= set(m) <= keys | {"workloads"}:
            e.append(f"end-to-end keys {sorted(m)}")
            continue
        _name(m["name"], "metric", e)
        if not UNIT.match(m["unit"]):
            e.append(f"unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            e.append(f"better {m['better']!r}")
        if m["source"] not in ("host_clock", "device_trace"):
            e.append(f"end-to-end source {m['source']!r}")
        if not 0.01 <= m["bound"] <= 0.25:
            e.append(f"bound of {m['name']} outside [0.01, 0.25]")
        has_setup |= m["name"] == "setup_s"
        for w in m.get("workloads", wnames):
            if w not in e2e_of:
                e.append(f"{m['name']} lists unknown cell {w}")
            else:
                e2e_of[w].add(m["name"])
    if not has_setup:
        e.append("no setup_s")
    layer_of: dict[str, set[str]] = {w: set() for w in wnames}
    for m in spec["per_layer"]:
        keys = {"name", "unit", "better", "source", "layer", "moves"}
        if not keys <= set(m) <= keys | {"workloads"}:
            e.append(f"per-layer keys {sorted(m)}")
            continue
        _name(m["name"], "metric", e)
        _line(m["layer"], f"layer of {m['name']}", e)
        if not UNIT.match(m["unit"]):
            e.append(f"unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            e.append(f"better {m['better']!r}")
        if m["source"] not in SOURCES:
            e.append(f"source {m['source']!r}")
        if m["name"].endswith("_roofline") and m["unit"] != "%":
            e.append(f"{m['name']}: a roofline share is in %")
        for w in m.get("workloads", [w for w in wnames
                                     if m["moves"] in e2e_of[w]]):
            if w not in e2e_of:
                e.append(f"{m['name']} lists unknown cell {w}")
            elif m["moves"] not in e2e_of[w]:
                e.append(f"{m['name']} moves {m['moves']}, which {w} "
                         f"does not report")
            else:
                layer_of[w].add(m["name"])
    for w in wnames:
        if "setup_s" not in e2e_of[w] or len(e2e_of[w]) < 2:
            e.append(f"cell {w} reports setup_s and another end-to-end "
                     f"metric")
        if not layer_of[w]:
            e.append(f"cell {w} reports no per-layer metric")
    return e
