"""The highest sweep rate the system sustains, found once by a sweep on
the chip (never part of a benchmark run):

    python3 -m tomobench.knee --workload tune-sweep4-over \
        --rates 2.5,3,3.5,4 --seconds 20 --seed 5

One process sets the open-loop cell up once, then offers each rate for
``--seconds`` (the cell's sizes and scheduler, a Poisson process at that
rate) and prints one JSON line per rate: completed over offered, the
sweeps completed inside the window a second, the median and 95th
percentile latency, and the backlog's trend: the mean latency of the
last third of the arrivals over that of the first third (about 1 where
the system keeps up, growing where the queue grows).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from .run import ROOT, _cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tomobench.knee")
    ap.add_argument("--workload", default="tune-sweep4-over")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows per rate, each with its own arrivals")
    a = ap.parse_args(argv)
    from . import bench, program
    from .record import quantile
    _cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = bench.cell(bench.load_spec(ROOT), ROOT, a.workload)
    prog = program.load(ROOT)
    drv = bench.driver(cell.traffic["kind"]).DRIVER(
        cell, prog, device, a.seed, a.seconds)
    drv.setup()
    runs = [(float(r), k) for r in a.rates.split(",")
            for k in range(a.repeat)]
    for rate, k in runs:
        drv.traffic = dict(drv.traffic, rate_per_s=rate)
        drv.seed = a.seed + k
        rec = drv.window()
        lat = [r.latency for r in rec.requests]
        third = max(1, len(lat) // 3)
        done = rec.done()
        inside = [r for r in done if r.end <= rec.t1]
        print(json.dumps({
            "rate_per_s": rate, "arrivals_seed": a.seed + k,
            "offered": len(rec.requests),
            "completed": len(done), "failed": len(rec.failed()),
            "completed_per_s": len(inside) / max(rec.t1 - rec.t0, 1e-9),
            "p50_s": quantile(lat, 0.5), "p90_s": quantile(lat, 0.9),
            "p95_s": quantile(lat, 0.95),
            "service_s": statistics.median(r.end - r.start for r in done),
            "trend": statistics.fmean(lat[-third:])
            / max(statistics.fmean(lat[:third]), 1e-9),
            "lateness_max_s": rec.extra.get("lateness_max_s")}),
            flush=True)
        drv.host_spans.clear()
    drv.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
