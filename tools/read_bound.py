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
(best and median), and the same copy on CUDA events.

Then the Paganin ROI's float32 volume (720 slices of 2560², 18,874,368,000
B), whose 32 GiB page-locked block is over the cap on a 96 GiB host
(``roi``), ``--roi-repeat`` times each:

* ``pageable``: ``src.cpu()``, the read where no page-locked block is
  had;
* ``first_touch``: no card, the host's part alone: 1, 2, 4 and 8
  threads copying a warm page-locked staging block's rows over their
  runs of a fresh array, with torch's ``copy_`` (as a lane does) and
  with numpy's ``copyto``;
* ``staged``: ``CudaTransport.read`` through staging blocks at 1, 2, 4
  and 8 lanes, on the kept pool of lane threads (``kept``) and on a
  pool made and shut down for each read (``per_read``), after one
  read that makes the staging blocks; its spans' ``staged``,
  ``reused``, ``chunks`` and ``lanes``; one read compared with
  ``src.cpu()`` bit for bit.

Prints one JSON line with the card's name and power limit.  Needs a
CUDA device:

    PYTHONPATH=src python tools/read_bound.py [--repeat 20] [--roi-repeat 3]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

SIZES = (419_430_400, 104_857_600)
#: the Paganin ROI's float32 volume: 720 slices of 2560²
ROI = (720, 2560, 2560)
LANES = (1, 2, 4, 8)


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


def _touch(np, dst, stage, threads: int, with_numpy: bool) -> float:
    """Seconds for ``threads`` threads to fill their runs of leading
    rows of ``dst`` (fresh; the staged read's runs), each from the rows
    of ``stage`` (warm, page-locked), a staging block's rows at a
    time."""
    from repro_torch.core.transport import stage_chunks, upload_plan
    rows = stage.shape[0]
    src = stage.numpy()
    runs = upload_plan(dst.shape, dst.element_size(), threads)

    def work(lo, hi):
        for a, b in stage_chunks(hi - lo, rows):
            if with_numpy:
                np.copyto(dst[lo + a:lo + b].numpy(), src[:b - a])
            else:
                dst[lo + a:lo + b].copy_(stage[:b - a])

    ts = [threading.Thread(target=work, args=r) for r in runs]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0


def measure_roi(torch, np, dev, repeat: int) -> dict:
    from repro_torch.core import CudaTransport, DataSet, transport
    from repro_torch.obs import Trace

    src = torch.randn(ROI, device=dev)
    torch.cuda.synchronize()
    nbytes = src.numel() * src.element_size()
    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    owned = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    out = {"shape": list(ROI), "bytes": nbytes, "cpus": os.cpu_count(),
           "intra_op_threads": torch.get_num_threads(),
           "upload_lanes": transport.UPLOAD_LANES,
           "stage_bytes": transport.STAGE_BYTES,
           "whole_block_fits": transport.pin_fits(
               owned, transport.pinned_block_bytes(nbytes), phys)}
    walls, events = _timed(torch, src.cpu, repeat)
    out["pageable"] = _rates(nbytes, walls)
    out["pageable_events"] = _rates(nbytes, events)

    rows = transport.stage_rows(ROI, 4)
    stage = torch.empty((rows, *ROI[1:]), pin_memory=True)
    stage.copy_(src[:rows])
    touch = []
    for k in LANES:
        row = {"threads": k}
        for name, with_numpy in (("copy_", False), ("numpy", True)):
            dst = torch.empty(ROI)
            row[name] = _rates(nbytes, [_touch(np, dst, stage, k,
                                               with_numpy)])
            del dst
        touch.append(row)
    out["first_touch"] = touch
    del stage

    ds = DataSet("recon", ROI, np.float32, ("z", "y", "x"), backing=src,
                 trace=Trace())
    tr = CudaTransport(dev)
    kept, lanes0 = transport._lane_pool, transport.UPLOAD_LANES
    t0 = time.perf_counter()
    vol = tr.read(ds)                       # makes the staging blocks
    out["first_staged_read_s"] = time.perf_counter() - t0
    out["bit_for_bit"] = bool(torch.equal(torch.from_numpy(vol),
                                          src.cpu()))
    del vol
    staged = {}
    try:
        for pool in ("kept", "per_read"):
            for k in LANES:
                transport.UPLOAD_LANES = k

                def read_per_read(k=k):
                    p = ThreadPoolExecutor(k, thread_name_prefix="read-lane")
                    transport._lane_pool = lambda: p
                    try:
                        return tr.read(ds)
                    finally:
                        p.shutdown()
                        transport._lane_pool = kept

                n0 = len(ds.trace.spans())
                walls, _ = _timed(torch, (lambda: tr.read(ds))
                                  if pool == "kept" else read_per_read,
                                  repeat)
                spans = [s.attrs for s in ds.trace.spans()[n0:]
                         if s.name == "transport.to_host"]
                staged[f"{pool}_{k}"] = {
                    **_rates(nbytes, walls),
                    "spans": [{a: s.get(a) for a in ("staged", "pinned",
                                                     "reused", "chunks",
                                                     "lanes")}
                              for s in spans[:1]],
                    "all_staged": all(s.get("staged") for s in spans),
                    "all_reused": all(s.get("reused") for s in spans)}
    finally:
        transport.UPLOAD_LANES, transport._lane_pool = lanes0, kept
    out["staged"] = staged
    del src, ds
    torch.cuda.empty_cache()
    return out


def measure(repeat: int, roi_repeat: int) -> dict:
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
    out["roi"] = measure_roi(torch, np, dev, roi_repeat)
    st = torch.cuda.host_memory_stats()
    out["host_memory_stats"] = {k: v for k, v in st.items()
                                if k.endswith(".current")
                                or k.startswith("num_host")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeat", type=int, default=20)
    p.add_argument("--roi-repeat", type=int, default=3)
    args = p.parse_args(argv)
    print(json.dumps({"read_bound": measure(args.repeat, args.roi_repeat)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
