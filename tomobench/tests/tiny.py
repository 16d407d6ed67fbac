"""A throwaway checkout for the CPU tests: a copy of this package with
tiny cells added as files of their own (configuration, traffic mix,
limits, a metric reader) and a ``BENCHMARK.json`` that names them, the
program linked in beside it."""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # tomobench/
REPO = HERE.parent

#: tiny geometry: 64 columns, 16 rows, 60 angles (divisible by 4 slots)
GEOM = {"n_det": 64, "n_rows": 16, "n_angles": 60}
#: the one-card cells' limit (the plain CPU path reads ~1e-6)
LIMIT = 1e-2


def tiny_config(name: str, base: dict, **over) -> dict:
    c = copy.deepcopy(base)
    c.update(GEOM, name=name, **over)
    return c


def make_root(tmp: Path, extra_metric: bool = True) -> Path:
    """A checkout at ``tmp``: ``tomobench/`` copied, ``src`` linked, and
    the tiny cells ``tiny-band``, ``tiny-sweep``, ``tiny-mpi`` (and a
    throwaway per-layer metric ``tiny.request_count``) added by files."""
    root = Path(tmp)
    shutil.copytree(HERE, root / "tomobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = root / "tomobench"
    one = json.loads((pkg / "configs" / "pco-edge-2560x1801.json")
                     .read_text())
    mpi = json.loads((pkg / "configs" / "pco-edge-2560x1800-mpi4.json")
                     .read_text())
    configs = {
        "tiny-64": tiny_config("tiny-64", one),
        "tiny-64-mpi": tiny_config("tiny-64-mpi", mpi,
                                   transport={"kind": "sharded",
                                              "slots": 4, "expect": 4}),
    }
    for name, c in configs.items():
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": name, "source": "tiny test size",
                                "file": f"tomobench/configs/{name}.json",
                                "reduced": ["n_det", "n_rows", "n_angles"],
                                "why": "CPU tests"})
    traffic = {
        "tiny-band": {"kind": "closed_runner",
                      "rows_per_request": 4, "pool_bands": 3,
                      "warmup_requests": 1,
                      "check": {"requests": 2, "slices_per_request": 2}},
        "tiny-sweep": {"kind": "open_sweeps", "rate_per_s": 8.0,
                       "rows_per_request": 2, "pool_bands": 4,
                       "sweep": {"plugin": "sinogram_filter",
                                 "param": "cutoff",
                                 "values": [0.4, 0.6, 0.8, 1.0]},
                       "workers": 1, "batch_identical": True,
                       "batch_max": 4, "max_history": 16,
                       "warmup_requests": 1, "drain_s": 30,
                       "check": {"requests": 2, "slices_per_request": 1}},
        "tiny-mpi": {"kind": "closed_sharded", "scans": 2,
                     "warmup_requests": 1,
                     "check": {"requests": 2, "slices_per_slot": 1}},
    }
    # each tiny cell reports what its committed twin reports
    cells = [("tiny-band", "tiny-64", "chain-band16"),
             ("tiny-sweep", "tiny-64", "tune-sweep4-over"),
             ("tiny-mpi", "tiny-64-mpi", "chain-band16")]
    for cell, conf, twin in cells:
        (pkg / "traffic" / f"{cell}.json").write_text(
            json.dumps(traffic[cell]))
        (pkg / "limits" / f"{cell}.json").write_text(json.dumps(
            {"recon_max_rel_err": {"limit": LIMIT}}))
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": cell, "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            wl = m.get("workloads")
            if wl is not None and twin in wl:
                wl.append(cell)
    # the sharded cell's own metric, its reader already a file
    spec["per_layer"].append({
        "name": "transport.alltoall_gbps", "unit": "GB/s",
        "better": "higher", "source": "program_counter",
        "layer": "ShardedTransport all-to-all (the pattern transition)",
        "moves": "slices_per_s", "workloads": ["tiny-mpi"]})
    if extra_metric:
        (pkg / "metrics" / "tiny.request_count.py").write_text(
            '"""Requests the window completed (a throwaway metric)."""\n\n\n'
            "def read(rec):\n    return len(rec.done())\n")
        spec["per_layer"].append({
            "name": "tiny.request_count", "unit": "requests",
            "better": "higher", "source": "host_clock",
            "layer": "Runner and transport: PluginRunner, CudaTransport, "
                     "ShardedTransport",
            "moves": "slices_per_s", "workloads": ["tiny-band"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_cell(root: Path, workload: str, seed: int, seconds: float = 1.0,
             trace: bool = False, control: str | None = None,
             patch: str = "", timeout: float = 240) -> dict:
    """Run ``workload`` of the checkout at ``root`` on the CPU in a new
    interpreter (so nothing else the test session loaded, such as JAX,
    is in the run's process), after executing ``patch`` (code that
    breaks the timed path underneath); returns the result line, the exit
    code, the standard error and the run's top-level modules."""
    code = "\n".join([
        "import sys, json, torch",
        "sys.path.insert(0, 'src')",
        patch,
        "from tomobench.run import run",
        f"rc = run({workload!r}, {seed}, {seconds}, {trace},"
        f" device=torch.device('cpu'), control={control!r})",
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0]"
        " for m in sys.modules})))",
        "sys.exit(rc)"])
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    mods = json.loads(lines[-1][len("MODULES "):]) if lines and \
        lines[-1].startswith("MODULES ") else []
    result = None
    for line in reversed(lines[:-1]):
        if line.startswith("{"):
            result = json.loads(line)
            break
    return {"rc": p.returncode, "result": result, "stderr": p.stderr,
            "modules": mods}
