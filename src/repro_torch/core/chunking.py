"""The Savu chunking optimiser (paper §IV.A, Table 1 + Eq (1)–(7)).

Given the first two access patterns of a dataset — *now* (how the plugin
that writes it slices) and *next* (how the following plugin reads it) —
choose per-dimension chunk values c_i that

  * minimise the number of chunks touched per frame access, while
  * keeping one chunk's byte size <= the cache budget M
    (HDF5 raw-chunk cache, default 1 MB, in the paper).

Dimension typing per pattern (paper Table 1):
  'core'  — a core dimension (delivered whole),
  'slice' — the *first* slice dimension (fastest-changing),
  'other' — any other slice dimension.

The published table is used as follows (c0 = start value, [lo, hi] =
bounds):

  (core , core ) : c0 = dim              bounds [1, dim]
  (core , slice) : c0 = min(f, dim)      bounds [1, min(f_p, dim)]
  (core , other) : c0 = 1                bounds [1, dim]
  (slice, slice) : c0 = min(f, dim)      bounds [1, min(f_p, dim)]
  (slice, other) : c0 = 1                bounds [1, dim]
  (other, other) : c0 = 1                fixed

(symmetric in now/next).  f = frames per plugin call, f_p = average
frames handled per process.  When growing, core dims are grown first;
when shrinking, slice dims are shrunk first — Eq (1)'s two branches.
Growth steps are +a for core dims and +a·f for slice dims; shrink steps
are half for core dims and −a·f for slice dims (Table 1's α columns).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .patterns import Pattern

DEFAULT_CACHE_BYTES = 1_000_000  # HDF5 raw data chunk cache (paper: 1MB)


@dataclasses.dataclass(frozen=True)
class DimPlan:
    dim: int
    size: int
    type_now: str
    type_next: str
    c0: int
    lo: int
    hi: int
    adjustable: bool
    kind: str  # 'core' | 'slice' | 'fixed' — adjustment family


def _dim_types(pattern: Pattern | None, ndim: int) -> list[str]:
    if pattern is None:
        return ["other"] * ndim
    return [pattern.dim_type(d) for d in range(ndim)]


def plan_dims(shape: Sequence[int], now: Pattern, next_: Pattern | None,
              frames: int, frames_per_proc: int) -> list[DimPlan]:
    ndim = len(shape)
    tn = _dim_types(now, ndim)
    tx = _dim_types(next_, ndim)
    plans = []
    for d in range(ndim):
        size = int(shape[d])
        pair = frozenset((tn[d], tx[d]))
        f = max(1, min(frames, size))
        fp = max(f, min(frames_per_proc, size))
        if pair == frozenset(("core",)):                     # core/core
            c0, lo, hi, adj, kind = size, 1, size, True, "core"
        elif pair == frozenset(("core", "slice")):
            c0, lo, hi, adj, kind = f, 1, fp, True, "slice"
        elif pair == frozenset(("core", "other")):
            c0, lo, hi, adj, kind = 1, 1, size, True, "core"
        elif pair == frozenset(("slice",)):                  # slice/slice
            c0, lo, hi, adj, kind = f, 1, fp, True, "slice"
        elif pair == frozenset(("slice", "other")):
            c0, lo, hi, adj, kind = 1, 1, size, True, "core"
        else:                                                # other/other
            c0, lo, hi, adj, kind = 1, 1, 1, False, "fixed"
        plans.append(DimPlan(d, size, tn[d], tx[d], min(c0, size), lo,
                             min(hi, size), adj, kind))
    return plans


def _product_bytes(c: list[int], itemsize: int) -> int:
    return int(np.prod(c, dtype=np.int64)) * itemsize


def optimise_chunks(shape: Sequence[int], now: Pattern,
                    next_: Pattern | None = None, *,
                    itemsize: int = 4, frames: int = 1,
                    frames_per_proc: int | None = None,
                    cache_bytes: int = DEFAULT_CACHE_BYTES) -> tuple[int, ...]:
    """Return the optimised per-dimension chunk tuple (paper Eq (1))."""
    if frames_per_proc is None:
        frames_per_proc = max(frames * 8, frames)
    plans = plan_dims(shape, now, next_, frames, frames_per_proc)
    c = [p.c0 for p in plans]

    # Shrink phase (Eq (1) lower branch): slice dims first, then core
    # dims, until one chunk fits in M.
    shrink_order = ([p for p in plans if p.adjustable and p.kind == "slice"] +
                    [p for p in plans if p.adjustable and p.kind == "core"])
    f = max(1, frames)
    guard = 0
    while _product_bytes(c, itemsize) > cache_bytes and guard < 10_000:
        guard += 1
        progressed = False
        for p in shrink_order:
            if _product_bytes(c, itemsize) <= cache_bytes:
                break
            cur = c[p.dim]
            if cur <= p.lo:
                continue
            if p.kind == "core":
                new = max(p.lo, cur // 2)            # α^d = c/2
            else:
                new = max(p.lo, cur - f)             # α^d = c − a·f (a=1)
            if new < cur:
                c[p.dim] = new
                progressed = True
        if not progressed:
            for p in shrink_order:
                c[p.dim] = p.lo
            break

    # Grow phase (Eq (1) upper branch): core dims first; the largest
    # integral step `a` keeping the chunk within the dim bound and M.
    grow_order = ([p for p in plans if p.adjustable and p.kind == "core"] +
                  [p for p in plans if p.adjustable and p.kind == "slice"])
    for p in grow_order:
        rest = _product_bytes(c, itemsize) // max(1, c[p.dim])
        if rest == 0:
            continue
        limit = min(p.hi, cache_bytes // rest if rest else p.hi)
        step = 1 if p.kind == "core" else f
        if limit <= c[p.dim]:
            continue
        a = (limit - c[p.dim]) // step
        c[p.dim] = c[p.dim] + a * step

    return tuple(int(v) for v in c)


def chunks_touched(shape: Sequence[int], chunks: Sequence[int],
                   index: tuple[slice, ...]) -> int:
    """Number of chunks a slab access touches (cost model for benches)."""
    n = 1
    for dim, (size, ch) in enumerate(zip(shape, chunks)):
        sl = index[dim]
        start = sl.start or 0
        stop = size if sl.stop is None else min(sl.stop, size)
        first = start // ch
        last = (stop - 1) // ch
        n *= (last - first + 1)
    return n


def naive_chunks(shape: Sequence[int], itemsize: int,
                 cache_bytes: int = DEFAULT_CACHE_BYTES) -> tuple[int, ...]:
    """The 'row-major greedy' baseline HDF5 guess (h5py-style): fill from
    the fastest-varying dim backwards until M is hit — pattern-oblivious."""
    c = [1] * len(shape)
    budget = max(1, cache_bytes // itemsize)
    for d in reversed(range(len(shape))):
        take = min(shape[d], budget)
        c[d] = max(1, take)
        budget = max(1, budget // max(1, shape[d]))
        if budget == 1:
            break
    return tuple(c)
