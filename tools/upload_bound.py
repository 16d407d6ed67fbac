#!/usr/bin/env python
"""The bound of a raw band's and a raw scan's hand-off from host memory
to the cards.

For each size (a 16-row band of the PCO.edge scan, 1801 x 16 x 2560
uint16, 147,537,920 B, and a slot's block of the whole scan over four
cards, 451 x 2160 x 2560 uint16, 4,987,699,200 B), alone on the card,
out of warm pageable host memory:

* ``pageable``: ``torch.from_numpy(a).to(dev)``, the copy before
  staging;
* ``pinned``: the same bytes DMAed out of one cached page-locked block
  (``non_blocking``, then a synchronise): the bound of the copy's DMA;
* ``staged``: ``CudaTransport._to_device`` through page-locked staging
  blocks (``_stage_to``) at 1, 2, 4 and 8 lanes (host threads), and for
  the band at staging blocks of 1, 4, 16 and 256 MiB, with the spans'
  ``staged``, ``reused`` (of the calls after the first), ``chunks``;
  the first call, which pins its staging blocks, apart.

Then ``four_slots``: the whole scan (1801 x 2160 x 2560 uint16,
19.92 GB) onto four slots (every card, or four slots of the one card),
slot after slot out of pageable memory as before (``old``), and staged
with every slot at once (``ShardedTransport._scatter``) at 4, 8 and 16
lanes (one, two and four a slot, at most the host's CPUs); the results
compared bit for bit.

Rates are GB/s on the host's clock around a copy that ends
synchronised (best and median).  Prints one JSON line with every
card's name and power limit and the host's CPUs.  Needs a CUDA device:

    PYTHONPATH=src python tools/upload_bound.py [--repeat 10] [--slots N]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BAND = (1801, 16, 2560)
SLOT = (451, 2160, 2560)
SCAN = (1801, 2160, 2560)
LANES = (1, 2, 4, 8)
STAGES_MIB = (1, 4, 16, 256)


def _cards() -> list[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi failed: {e!r}"]


def _rates(nbytes: int, walls: list[float]) -> dict:
    return {"best_gbps": nbytes / min(walls) / 1e9,
            "median_gbps": nbytes / statistics.median(walls) / 1e9,
            "best_ms": 1e3 * min(walls), "runs": len(walls)}


def _walls(torch, fn, repeat: int, devs) -> list[float]:
    """Host seconds of ``repeat`` calls of ``fn``, each ending with every
    card in ``devs`` synchronised; each result dropped before the next."""
    walls = []
    for _ in range(repeat):
        for d in devs:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = fn()
        for d in devs:
            torch.cuda.synchronize(d)
        walls.append(time.perf_counter() - t0)
        del out
    return walls


def _same(torch, x, y) -> bool:
    """Bit for bit equal (bytes compared: the card has few uint16 ops)."""
    return x.shape == y.shape and x.dtype == y.dtype and bool(torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)))


def _host(torch, shape, devs) -> "np.ndarray":
    """Seeded uint16 counts of ``shape`` in fresh pageable host memory,
    made on the cards a block at a time (every page touched)."""
    import numpy as np
    a = np.empty(shape, np.uint16)
    step = -(-shape[0] // len(devs))
    for j, lo in enumerate(range(0, shape[0], step)):
        hi = min(lo + step, shape[0])
        g = torch.Generator(device=devs[j]).manual_seed(31 + j)
        t = torch.randint(-32768, 32767, (hi - lo, *shape[1:]),
                          dtype=torch.int16, device=devs[j], generator=g)
        a[lo:hi] = t.cpu().numpy().view(np.uint16)
        del t
    return a


def _staged(torch, transport, fn, nbytes, repeat, cards, ds, want,
            lanes, stage) -> dict:
    """``fn()`` (a staged hand-off) at ``lanes`` lanes through staging
    blocks of ``stage`` bytes: the first call, which pins its staging
    blocks, apart; the spans of ``ds``; the result against ``want``."""
    lanes0, stage0 = transport.UPLOAD_LANES, transport.STAGE_BYTES
    transport.UPLOAD_LANES, transport.STAGE_BYTES = lanes, stage
    try:
        first = _walls(torch, fn, 1, cards)
        walls = _walls(torch, fn, repeat, cards)
        got = fn()
        same = (all(_same(torch, x, y) for x, y in zip(got.shards, want))
                if hasattr(got, "shards") else _same(torch, got, want))
        del got
    finally:
        transport.UPLOAD_LANES, transport.STAGE_BYTES = lanes0, stage0
    spans = [s for s in ds.trace.spans() if s.name == "transport.to_device"]
    ds.trace = type(ds.trace)()
    return {"lanes": lanes, "stage_bytes": stage,
            "first_ms": 1e3 * first[0], **_rates(nbytes, walls),
            "span_gbps": statistics.median(
                s.attrs["bytes"] / (s.end - s.start) / 1e9
                for s in spans[1:]),
            "staged": all(s.attrs["staged"] for s in spans),
            "reused": sum(bool(s.attrs["reused"]) for s in spans[1:]),
            "chunks": spans[0].attrs["chunks"], "equal": same}


def one_card(torch, transport, a, dev, repeat: int, slot: bool) -> dict:
    """The copies of host array ``a`` to card ``dev``; ``slot``: a slot's
    block of the scan (fewer runs, the default staging blocks), else a
    band (staging blocks of 1, 4, 16 and 256 MiB)."""
    from repro_torch.core import CudaTransport, DataSet
    from repro_torch.obs import Trace

    nbytes = a.nbytes
    row = {"bytes": nbytes, "shape": list(a.shape)}
    slow = max(2, repeat // 3) if slot else repeat
    row["pageable"] = _rates(nbytes, _walls(
        torch, lambda: torch.from_numpy(a).to(dev), slow, [dev]))
    want = torch.from_numpy(a).to(dev)
    pinned = torch.from_numpy(a).pin_memory()
    row["pinned"] = _rates(nbytes, _walls(
        torch, lambda: pinned.to(dev, non_blocking=True), slow, [dev]))
    del pinned
    tr = CudaTransport(dev)
    ds = DataSet("tomo", a.shape, a.dtype, ("a", "b", "c"), backing=a,
                 trace=Trace())
    stages = ((transport.STAGE_BYTES,) if slot else
              tuple(m << 20 for m in STAGES_MIB))
    row["staged"] = [
        _staged(torch, transport, lambda: tr._to_device(ds, a), nbytes,
                slow, [dev], ds, want, lanes, stage)
        for stage in stages for lanes in LANES]
    return row


def four_slots(torch, transport, devs, repeat: int) -> dict:
    from repro_torch.core import DataSet, ShardedTransport
    from repro_torch.obs import Trace

    tr = ShardedTransport(devs)
    a = _host(torch, SCAN, list(dict.fromkeys(devs)))
    bounds = tr._slot_bounds("tomo", a.shape, 0)
    blocks = [a[lo:hi] for lo, hi in bounds]
    out = {"bytes": a.nbytes, "split": [hi - lo for lo, hi in bounds]}
    cards = list(dict.fromkeys(devs))

    def old():
        return [transport.to_tensor(b, d) for b, d in zip(blocks, devs)]

    out["old"] = _rates(a.nbytes, _walls(torch, old, max(2, repeat // 3),
                                         cards))
    want = old()
    ds = DataSet("tomo", a.shape, a.dtype, ("a", "b", "c"), backing=a,
                 trace=Trace())
    out["staged"] = [
        _staged(torch, transport, lambda: tr._scatter(a, 0, "tomo", ds),
                a.nbytes, repeat, cards, ds, want, lanes,
                transport.STAGE_BYTES)
        for lanes in (4, 8, 16)]
    return out


def measure(repeat: int, slots: int | None) -> dict:
    import torch

    from repro_torch.core import transport

    if not torch.cuda.is_available():
        raise SystemExit("upload_bound.py needs a CUDA device")
    dev = transport.slots_on("cuda", 1)[0]
    devs = (transport.slots_on("cuda") if slots is None
            else transport.slots_on("cuda", slots))
    if len(devs) == 1:
        devs = transport.slots_on("cuda", 4)
    out = {"cards": _cards(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "cpus": os.cpu_count(),
           "slots": [str(d) for d in devs],
           "upload_bytes": transport.UPLOAD_BYTES,
           "upload_lanes": transport.UPLOAD_LANES,
           "stage_bytes": transport.STAGE_BYTES}
    for name, shape in (("band", BAND), ("slot", SLOT)):
        a = _host(torch, shape, [dev])
        out[name] = one_card(torch, transport, a, dev, repeat,
                             slot=name == "slot")
        del a
        torch.cuda.empty_cache()
    out["four_slots"] = four_slots(torch, transport, devs, repeat)
    st = torch.cuda.host_memory_stats()
    out["host_memory_stats"] = {k: v for k, v in st.items()
                                if k.endswith(".current")
                                or k.startswith("num_host")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--slots", type=int, default=None,
                   help="slots on the current card (default: every card, "
                        "or four slots where one card is visible)")
    args = p.parse_args(argv)
    print(json.dumps({"upload_bound": measure(args.repeat, args.slots)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
