#!/usr/bin/env python
"""The bound of a sharded volume's gather off the cards into host memory.

A gather writes each card's block into a fresh host array, so beside
the cards' copies it pays the first touch of every destination page.
Measured on the host and cards the command finds:

* ``first_touch``: the write rate into fresh host memory at 1, 4, 8
  and 16 threads, each thread copying a warm 256 MiB source into its
  own share (torch's intra-op threads set to 1), and the same copy
  again into the pages just touched (``warm``); ``first_touch_default``:
  one ``copy_`` a piece with torch's intra-op threads as they are; and
  ``first_touch_hugepage``, the same at 1 and 4 threads into memory
  advised ``MADV_HUGEPAGE`` (the host's transparent huge page mode in
  ``thp``); ``populate``: fresh memory the kernel faults in at once
  when it maps it (``MAP_POPULATE``), no copy;
* ``dma``: every slot's card copying its block at once into two cached
  256 MiB page-locked blocks, chunk after chunk on a stream of its own,
  and the first card alone;
* ``gather_old``: ``ShardedTensor.numpy()``, the blocks copied card
  after card into pageable memory; ``gather_new``:
  ``CudaTransport.read`` of the dataset (``_gather_off_cards``), with its
  spans' ``pinned``, ``reused`` and ``chunks``; the two results
  compared bit for bit.

Rates are GB/s on the host's clock around work that ends synchronised
(best and median).  The volume is ``--rows`` slices of 2560² float32 a
slot (540: the 2160-slice scan over four cards, 56.62 GB).  Prints one
JSON line with every card's name and power limit.  Needs a CUDA device:

    PYTHONPATH=src python tools/gather_bound.py [--rows 540] [--slots N]
"""
from __future__ import annotations

import argparse
import json
import mmap
import os
import statistics
import subprocess
import sys
import threading
import time

SIDE = 2560
THREADS = (1, 4, 8, 16)
PIECE = 256 << 20


def _cards() -> list[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi failed: {e!r}"]


def _thp() -> str:
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            return f.read().strip()
    except OSError as e:
        return f"unread: {e!r}"


def _rates(nbytes: int, walls: list[float]) -> dict:
    return {"best_gbps": nbytes / min(walls) / 1e9,
            "median_gbps": nbytes / statistics.median(walls) / 1e9,
            "best_s": min(walls), "runs": len(walls)}


def _fill(torch, dst, src, threads: int) -> float:
    """Seconds for ``threads`` threads to copy ``src`` over their shares
    of ``dst`` (uint8), a piece of ``src``'s size at a time."""
    n = dst.numel()
    bounds = [(n * i // threads, n * (i + 1) // threads)
              for i in range(threads)]

    def work(lo, hi):
        for at in range(lo, hi, src.numel()):
            m = min(src.numel(), hi - at)
            dst[at:at + m].copy_(src[:m])

    ts = [threading.Thread(target=work, args=b) for b in bounds]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0


def populate(nbytes: int) -> dict:
    """The rate at which the kernel maps in ``nbytes`` of fresh
    anonymous memory that it faults in at once (``MAP_POPULATE``), or
    the error."""
    t0 = time.perf_counter()
    try:
        mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE
                       | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    except OSError as e:
        return {"error": repr(e)}
    wall = time.perf_counter() - t0
    mm.close()
    return {"populate_gbps": nbytes / wall / 1e9}


def first_touch(torch, nbytes: int) -> dict:
    src = torch.ones(PIECE, dtype=torch.uint8)
    out = {"bytes": nbytes, "intra_op_threads": torch.get_num_threads()}
    one = torch.get_num_threads()
    rows = []
    torch.set_num_threads(1)
    try:
        for k in THREADS:
            dst = torch.empty(nbytes, dtype=torch.uint8)
            cold = _fill(torch, dst, src, k)
            warm = _fill(torch, dst, src, k)
            rows.append({"threads": k,
                         "first_touch_gbps": nbytes / cold / 1e9,
                         "warm_gbps": nbytes / warm / 1e9})
            del dst
        huge = []
        for k in (1, 4):
            mm = mmap.mmap(-1, nbytes)
            mm.madvise(mmap.MADV_HUGEPAGE)
            dst = torch.frombuffer(mm, dtype=torch.uint8)
            cold = _fill(torch, dst, src, k)
            huge.append({"threads": k,
                         "first_touch_gbps": nbytes / cold / 1e9})
            del dst
            mm.close()
    finally:
        torch.set_num_threads(one)
    dst = torch.empty(nbytes, dtype=torch.uint8)
    cold = _fill(torch, dst, src, 1)
    out["populate"] = populate(nbytes)
    out.update(threads=rows, first_touch_hugepage=huge, first_touch_default={
        "threads": 1, "intra_op_threads": one,
        "first_touch_gbps": nbytes / cold / 1e9})
    return out


def dma(torch, blocks) -> dict:
    """Each block copied into two cached page-locked 256 MiB blocks of
    its card, chunk after chunk on a stream of its own, every card at
    once, then the first alone."""
    rows = PIECE // (blocks[0][0].numel() * 4)
    stages = [[torch.empty((rows, SIDE, SIDE), pin_memory=True)
               for _ in range(2)] for _ in blocks]
    streams = [torch.cuda.Stream(b.device) for b in blocks]

    def run(which) -> float:
        for b in blocks:
            torch.cuda.synchronize(b.device)
        t0 = time.perf_counter()
        for j in which:
            b, s = blocks[j], streams[j]
            with torch.cuda.stream(s):
                for i, lo in enumerate(range(0, b.shape[0], rows)):
                    hi = min(lo + rows, b.shape[0])
                    stages[j][i % 2][:hi - lo].copy_(b[lo:hi],
                                                     non_blocking=True)
        for j in which:
            streams[j].synchronize()
        return time.perf_counter() - t0

    run(range(len(blocks)))                     # warm
    every = [run(range(len(blocks))) for _ in range(3)]
    one = [run([0]) for _ in range(3)]
    total = sum(b.numel() * 4 for b in blocks)
    return {"chunk_rows": rows, "all": _rates(total, every),
            "first_alone": _rates(blocks[0].numel() * 4, one)}


def measure(rows: int, slots: int | None, repeat: int, repeat_old: int,
            touch_bytes: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import CudaTransport, DataSet, ShardedTensor
    from repro_torch.core.transport import slots_on
    from repro_torch.obs import Trace

    if not torch.cuda.is_available():
        raise SystemExit("gather_bound.py needs a CUDA device")
    devs = slots_on("cuda", slots)
    out = {"cards": _cards(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "slots": [str(d) for d in devs],
           "cpus": os.cpu_count(), "thp": _thp(),
           "phys_bytes": os.sysconf("SC_PHYS_PAGES")
           * os.sysconf("SC_PAGE_SIZE"), "rows_a_slot": rows}
    out["first_touch"] = first_touch(torch, touch_bytes)
    blocks = []
    for j, d in enumerate(devs):
        g = torch.Generator(device=d).manual_seed(j)
        blocks.append(torch.randn((rows, SIDE, SIDE), device=d,
                                  generator=g))
    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)
    out["dma"] = dma(torch, blocks)
    st = ShardedTensor(blocks, 0, devs)
    nbytes = sum(b.numel() * 4 for b in blocks)
    out["bytes"] = nbytes
    walls = []
    for _ in range(repeat_old):
        t0 = time.perf_counter()
        old = st.numpy()
        walls.append(time.perf_counter() - t0)
        if len(walls) < repeat_old:
            del old
    out["gather_old"] = _rates(nbytes, walls)
    ds = DataSet("recon", st.shape, np.float32, ("z", "y", "x"),
                 backing=st, trace=Trace())
    tr = CudaTransport(devs[0])
    walls, same = [], None
    for _ in range(repeat):
        t0 = time.perf_counter()
        new = tr.read(ds)
        walls.append(time.perf_counter() - t0)
        if same is None:
            same = bool(torch.equal(torch.from_numpy(new),
                                    torch.from_numpy(old)))
            del old
        del new
    spans = [s for s in ds.trace.spans() if s.name == "transport.to_host"]
    out["gather_new"] = _rates(nbytes, walls)
    out["gather_new"].update(
        equal_to_old=same, chunks=spans[0].attrs["chunks"],
        pinned=[bool(s.attrs["pinned"]) for s in spans],
        reused=[bool(s.attrs["reused"]) for s in spans],
        span_gbps=[s.attrs["bytes"] / (s.end - s.start) / 1e9
                   for s in spans])
    st_host = torch.cuda.host_memory_stats()
    out["host_memory_stats"] = {k: v for k, v in st_host.items()
                                if k.endswith(".current")
                                or k.startswith("num_host")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=540,
                   help="2560² float32 slices a slot")
    p.add_argument("--slots", type=int, default=None,
                   help="slots on the current card (default: every card)")
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--repeat-old", type=int, default=2)
    p.add_argument("--touch-gib", type=int, default=8,
                   help="GiB of fresh host memory a first-touch run writes")
    args = p.parse_args(argv)
    print(json.dumps({"gather_bound": measure(
        args.rows, args.slots, args.repeat, args.repeat_old,
        args.touch_gib << 30)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
