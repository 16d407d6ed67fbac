"""Run one cell of the benchmark once.

    python3 -m tomobench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (the directory of ``BENCHMARK.json``; the
program is its ``src/repro_torch``).  The run makes its scans from the
seed, sets the system up and warms it with the cell's own requests
(``setup_s``), measures for ``--seconds``, then compares a seeded sample
of what the window produced with the plain reference.  Its last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit
(also the last lines of standard error).

It exits non-zero and prints no result without as many CUDA cards as the
cell asks for, without the program, or when the process holds jax,
jaxlib, flax or the reference package ``repro`` once the window has
closed.  Every cache the program builds stays inside the checkout
(``build/``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The epoch time this process started (Linux; else now)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - \
            ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: Path = ROOT, device=None, control: str | None = None,
        out=None, err=None) -> int:
    """One run; returns the exit code.  ``device`` None is the measured
    run, which needs the cards; tests pass ``torch.device("cpu")``.
    ``control``: a precision the reference stands in for the program
    with (the comparison's control), instead of the program."""
    from . import bench, devtrace, program
    out = out or sys.stdout
    err = err or sys.stderr
    spec = bench.load_spec(root)
    cell = bench.cell(spec, root, workload)
    _cache_dirs(root)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"tomobench: {workload} needs {cell.chips} CUDA card(s), "
                  f"this host has {n}", file=err)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    prog = program.load(root)
    drv = bench.driver(cell.traffic["kind"]).DRIVER(cell, prog, device, seed,
                                                    seconds)
    drv.setup()
    setup_s = time.time() - T_START
    with devtrace.DeviceTrace(trace) as dt:
        rec = drv.window()
    rec.setup_s = setup_s
    if trace:
        rec.device = dt.summary(rec.t0, rec.t1, drv.devices(),
                                rec.host_spans + [s for r in rec.requests
                                                  for s in r.spans
                                                  if s.name != "queue.wait"])
        dt.prof = None
    cards = drv.devices()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    drv.free()
    checks = drv.check(rec, (control,))[control]
    leaked = program.forbidden_modules()
    if leaked:
        print(f"tomobench: the run loaded {', '.join(leaked)}", file=err)
        return 3
    metrics = bench.read_metrics(cell.per_layer() if trace
                                 else cell.end_to_end(), rec)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": len(cards) if device.type == "cuda" else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(checks) and all(c.ok for c in checks)
              and not rec.failed(),
              "attempted": len(rec.requests), "failed": len(rec.failed()),
              "metrics": metrics, "device": dev}
    if trace and rec.device is not None:
        dev["busy_s"] = rec.device.mean_busy_s
        dev["window_s"] = rec.device.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in rec.device.device_ops],
            "idle_gaps": [[n, s] for n, s in rec.device.idle_gaps]}
    result["checks"] = {c.name: c.as_json() for c in checks}
    for r in rec.failed()[:5]:
        print(f"tomobench: request {r.index} failed: {r.error}", file=err)
    if "lateness_max_s" in rec.extra:
        print(f"tomobench: the generator ran at most "
              f"{rec.extra['lateness_max_s']!r} s late", file=err)
    for c in checks:
        print(c.line(), file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tomobench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        return run(a.workload, a.seed, a.seconds, bool(a.trace))
    except FileNotFoundError as e:
        print(f"tomobench: {e}", file=sys.stderr)
        return 4


if __name__ == "__main__":
    sys.exit(main())
