#!/usr/bin/env python
"""The bound of a volume's read off the card into host memory.

For each size (a 16-slice band's float32 volume, 419,430,400 B, and a
4-slice sweep member's, 104,857,600 B), alone on the card:

* ``new_block_s``: the first page-locked block of that size (the
  caching host allocator pins new pages);
* ``pinned``: ``dst.copy_(src)`` into that block, already cached,
  ``--repeat`` times: the bound of ``transport.to_host_gbps``;
* ``read``: ``CudaTransport.read`` of a card-resident dataset, the
  result dropped between reads, so each takes the cached block; its
  spans' ``pinned`` and ``reused``;
* ``pageable``: ``src.cpu()`` into fresh pageable memory each time,
  the read before page-locked blocks.

Each as GB/s on the host's clock around a copy that ends synchronised
(best and median), and the same copy on CUDA events.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA device:

    PYTHONPATH=src python tools/read_bound.py [--repeat 20]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SIZES = (419_430_400, 104_857_600)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def _rates(nbytes: int, walls: list[float]) -> dict:
    return {"best_gbps": nbytes / min(walls) / 1e9,
            "median_gbps": nbytes / statistics.median(walls) / 1e9,
            "best_ms": 1e3 * min(walls), "runs": len(walls)}


def _timed(torch, fn, repeat: int) -> tuple[list[float], list[float]]:
    """Host seconds and CUDA-event seconds of ``repeat`` calls of
    ``fn``, each ending synchronised."""
    walls, events = [], []
    for _ in range(repeat):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(a.elapsed_time(b) / 1e3)
        del out
    return walls, events


def measure(repeat: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import CudaTransport, DataSet
    from repro_torch.obs import Trace

    if not torch.cuda.is_available():
        raise SystemExit("read_bound.py needs a CUDA device")
    dev = torch.device("cuda")
    out = {"card": _card(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "phys_bytes": os.sysconf("SC_PHYS_PAGES")
           * os.sysconf("SC_PAGE_SIZE"), "sizes": {}}
    for nbytes in SIZES:
        n = nbytes // 4
        src = torch.randn(n, device=dev)
        torch.cuda.synchronize()
        stats0 = torch.cuda.host_memory_stats()
        t0 = time.perf_counter()
        dst = torch.empty(n, pin_memory=True)
        new_block = time.perf_counter() - t0
        stats1 = torch.cuda.host_memory_stats()
        row = {"new_block_s": new_block,
               "new_block_allocs": stats1["num_host_alloc"]
               - stats0["num_host_alloc"],
               "owned_bytes_after": stats1["allocated_bytes.current"]}
        walls, events = _timed(torch, lambda: dst.copy_(src), repeat)
        row["pinned"] = _rates(nbytes, walls)
        row["pinned_events"] = _rates(nbytes, events)
        if not torch.equal(dst, src.cpu()):
            raise SystemExit("the page-locked copy differs from the card's")
        del dst
        row["owned_bytes_after_free"] = \
            torch.cuda.host_memory_stats()["allocated_bytes.current"]
        ds = DataSet("recon", (n,), np.float32, ("x",), backing=src,
                     trace=Trace())
        tr = CudaTransport(dev)
        walls, _ = _timed(torch, lambda: tr.read(ds), repeat)
        spans = [s.attrs for s in ds.trace.spans()
                 if s.name == "transport.to_host"]
        row["read"] = _rates(nbytes, walls)
        row["read_pinned"] = sum(bool(a["pinned"]) for a in spans)
        row["read_reused"] = sum(bool(a["reused"]) for a in spans)
        walls, events = _timed(torch, src.cpu, max(3, repeat // 4))
        row["pageable"] = _rates(nbytes, walls)
        row["pageable_events"] = _rates(nbytes, events)
        out["sizes"][str(nbytes)] = row
        del src, ds
        torch.cuda.empty_cache()
    st = torch.cuda.host_memory_stats()
    out["host_memory_stats"] = {k: v for k, v in st.items()
                                if k.endswith(".current")
                                or k.startswith("num_host")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeat", type=int, default=20)
    args = p.parse_args(argv)
    print(json.dumps({"read_bound": measure(args.repeat)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
