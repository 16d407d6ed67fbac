"""Readings that a cell's limits are set from, on the chip at the
cell's own size (never part of a benchmark run):

    python3 -m tomobench.calibrate --workload chain-band16 \
        --seeds 11,12,13 --seconds 4 --modes program,bf16

For each seed, one process sets the cell up, runs a short window at the
cell's own load, and compares the window's sample with the float32
reference for each candidate: ``program`` (the lower reading comes from
a dozen seeds or more of these) and the controls, the reference itself
in a lower precision standing in for the program (``bf16``,
``bf16_storage``; the upper reading).  One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import ROOT, _cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tomobench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--modes", default="program,bf16")
    a = ap.parse_args(argv)
    from . import bench, program
    _cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = bench.load_spec(ROOT)
    cell = bench.cell(spec, ROOT, a.workload)
    prog = program.load(ROOT)
    modes = [None if m == "program" else m for m in a.modes.split(",")]
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.time()
        drv = bench.driver(cell.traffic["kind"]).DRIVER(
            cell, prog, device, seed, a.seconds)
        drv.setup()
        rec = drv.window()
        drv.free()
        t1 = time.time()
        checks = drv.check(rec, modes)
        line = {"workload": a.workload, "seed": seed,
                "requests": len(rec.requests), "failed": len(rec.failed()),
                "setup_and_window_s": t1 - t0,
                "check_s": time.time() - t1}
        for m, cs in checks.items():
            for c in cs:
                line[f"{m or 'program'}.{c.name}"] = c.value
        print(json.dumps(line), flush=True)
        del drv, rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
