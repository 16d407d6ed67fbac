"""Dry-run and roofline tables from the per-cell JSON records, with the
H100's memory (``analysis.HBM_BYTES``) as the line a cell must fit
under."""
from __future__ import annotations

import glob
import json
import os

from .analysis import HBM_BYTES


def load_cells(out_dir: str = "experiments/dryrun") -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def dryrun_table(cells: list[dict]) -> str:
    lines = [
        "| cell | mesh | state/dev | peak HBM/dev | compile | knobs |",
        "|---|---|---|---|---|---|",
    ]
    for r in sorted(cells, key=lambda r: (r["shape"], r["arch"],
                                          r["tag"])):
        knobs = []
        if r.get("microbatch"):
            knobs.append(f"mb={r['microbatch']}")
        if r.get("remat_policy") not in (None, "dots"):
            knobs.append(f"remat={r['remat_policy']}")
        if r.get("moments") not in (None, "fp32"):
            knobs.append(f"adam={r['moments']}")
        mesh = "x".join(str(s) for s in r["mesh"])
        peak = r["memory"]["peak_estimate"] / 2**30
        flag = " ⚠" if r["memory"]["peak_estimate"] > HBM_BYTES else ""
        lines.append(
            f"| {r['arch']} {r['shape']} | {mesh} | "
            f"{r['state_bytes_per_device'] / 2**30:.2f} GiB | "
            f"{peak:.2f} GiB{flag} | {r['compile_s']:.0f}s | "
            f"{' '.join(knobs) or '—'} |")
    return "\n".join(lines)


def roofline_table(cells: list[dict], mesh_filter: str = "pod") -> str:
    lines = [
        "| cell | compute | memory | collective | bottleneck | "
        "6ND/HLO | roofline-frac |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(cells, key=lambda r: (r["shape"], r["arch"])):
        if not r["tag"].endswith("__" + mesh_filter):
            continue
        ro = r["roofline"]
        dom = max(ro["compute_s"], ro["memory_s"], ro["collective_s"])
        frac = ro["compute_s"] / dom if dom else 0.0
        lines.append(
            f"| {r['arch']} {r['shape']} | "
            f"{ro['compute_s'] * 1e3:.1f} ms | "
            f"{ro['memory_s'] * 1e3:.1f} ms | "
            f"{ro['collective_s'] * 1e3:.1f} ms | "
            f"{ro['bottleneck']} | {ro['useful_ratio']:.2f} | "
            f"{frac:.2f} |")
    return "\n".join(lines)


def summary_stats(cells: list[dict]) -> dict:
    out = {"n_cells": len(cells), "over_hbm": 0, "bottlenecks": {}}
    for r in cells:
        if r["memory"]["peak_estimate"] > HBM_BYTES:
            out["over_hbm"] += 1
        b = r["roofline"]["bottleneck"]
        out["bottlenecks"][b] = out["bottlenecks"].get(b, 0) + 1
    return out


if __name__ == "__main__":
    cells = load_cells()
    print(dryrun_table(cells))
    print()
    print(roofline_table(cells))
    print()
    print(json.dumps(summary_stats(cells), indent=1))
