"""Transports — who moves the data (paper §III.A / §IV).

Four interchangeable backends, selected at runner construction.  Each
computes on torch devices, ``"cuda"`` unless the caller passes
``device="cpu"``:

* :class:`CudaTransport` — the production mode on one device: datasets
  live on the device as tensors, each plugin step is built once per step
  key, and a step receives the whole frame stack at once (every tomo op
  takes leading dims; a hand-written kernel cannot be vmapped one frame
  at a time).
* :class:`ShardedTransport` — Savu's MPI mode over several slots (the
  cards of the host, or repeats of one device): each dataset is split
  along its pattern's first slice dim (:meth:`Pattern.to_spec`), every
  slot runs the built step on its share, and a change of pattern between
  plugins is an all-to-all between the slots, not a file round trip.
* :class:`InMemoryTransport` — the paper's "serial on a PC" mode: host
  numpy storage, a loop over groups of ``n_frames`` frames, each group
  moved to the device and back.
* :class:`ChunkedFileTransport` — the out-of-core mode: every dataset is
  a chunk-addressed file (np.memmap standing in for parallel HDF5) with
  an LRU chunk cache of the paper's 1 MB default; chunk layouts come
  from the §IV.A optimiser.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import math
import os
import shutil
import tempfile
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..device import resolve_device
from ..kernels.tally import note_blocks, tally
from ..obs.trace import current_trace
from .chunking import DEFAULT_CACHE_BYTES, naive_chunks, optimise_chunks
from .dataset import DataSet
from .patterns import Pattern
from .plugin import BasePlugin


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (datasets carry numpy dtypes)."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def to_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` (tensor, sharded tensor or array-like) as a tensor on
    ``device``."""
    if isinstance(a, (torch.Tensor, ShardedTensor)):
        return a.to(device)
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_numpy(a) -> np.ndarray:
    """``a`` as a host numpy array (``np.asarray`` refuses CUDA tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    if isinstance(a, ShardedTensor):
        return a.numpy()
    return np.asarray(a)


def _on(device: torch.device):
    """``device`` current for the block (a no-op for the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _from_host(a, device: torch.device) -> bool:
    """Whether handing ``a`` to ``device`` copies it out of host memory:
    a numpy array, or a CPU tensor bound for a card."""
    return isinstance(a, np.ndarray) or (
        isinstance(a, torch.Tensor) and a.device.type == "cpu"
        and device.type != "cpu")


def _nbytes(a) -> int:
    return (a.numel() * a.element_size() if isinstance(a, torch.Tensor)
            else a.nbytes)


def _devices_of(devices: Sequence[torch.device]) -> str:
    return ",".join(dict.fromkeys(str(d) for d in devices))


def _to_device_span(ds: DataSet | None, a, to: torch.device, **attrs):
    """A ``transport.to_device`` span around the block when handing
    ``a`` (``ds``'s data) to device ``to`` copies it out of host memory
    (no span otherwise).  ``attrs`` add to, or replace, its ``bytes``,
    ``dataset``, ``device`` and ``pinned`` (of the source).  Bound for a
    card, the span also says whether the copy went through page-locked
    staging blocks (``staged``; :func:`_stage_to`, :func:`_stage_blocks`),
    whether every staging block came from the caching host allocator's
    cache (``reused``) and the chunks staged (``chunks``): the block
    sets them.  Yields the span's attributes.  What the host sees of
    the copy: a staged copy ends when its last chunk's DMA has
    completed, a pageable copy may return before its last DMA ends."""
    if ds is None or not _from_host(a, to):
        return contextlib.nullcontext({})
    if to.type == "cuda":
        attrs = {"staged": False, "reused": False, "chunks": 0, **attrs}
    return _copy_span("transport.to_device", ds, **{
        "bytes": _nbytes(a), "dataset": ds.name, "device": str(to),
        # a numpy array is never page-locked
        "pinned": isinstance(a, torch.Tensor) and a.is_pinned(), **attrs})


@contextlib.contextmanager
def _copy_span(name: str, ds: DataSet, **attrs):
    """Record ``name`` (``transport.to_device``, ``transport.to_host``,
    ``transport.alltoall``) around the block, on the epoch clock, on the
    trace of the request that owns ``ds``, else on the current trace,
    else nowhere.  Yields the span's attributes, which the block may
    complete."""
    tr = ds.trace if ds.trace is not None else current_trace()
    t0 = time.time()
    yield attrs
    if tr is not None:
        tr.record(name, t0, time.time(), attrs=attrs)


def pinned_block_bytes(nbytes: int) -> int:
    """The bytes torch's caching host allocator takes for a request of
    ``nbytes``: the next power of two (none for an empty one)."""
    return 0 if nbytes <= 0 else 1 << (nbytes - 1).bit_length()


def pin_fits(owned: int, nbytes: int, phys: int) -> bool:
    """Whether a read of ``nbytes`` may take a page-locked block: the
    bytes the caching host allocator owns (``owned``, blocks in use and
    cached) and the block it would take stay within a quarter of the
    host's physical memory ``phys``.  This bounds what results held by
    callers can pin."""
    return 4 * (owned + pinned_block_bytes(nbytes)) <= phys


def _pinned(shapes: Sequence[Sequence[int]], dtype: torch.dtype
            ) -> tuple[list[torch.Tensor], bool] | None:
    """Page-locked host blocks of ``shapes`` from torch's caching host
    allocator, and whether the allocator had every one cached.  None
    where :func:`pin_fits` refuses them or the allocation fails."""
    nbytes = sum(pinned_block_bytes(math.prod(s) * dtype.itemsize)
                 for s in shapes)
    before = torch.cuda.host_memory_stats()
    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if not pin_fits(before["allocated_bytes.current"], nbytes, phys):
        return None
    try:
        blocks = [torch.empty(s, dtype=dtype, pin_memory=True)
                  for s in shapes]
    except RuntimeError:            # no page-locked memory to be had
        return None
    after = torch.cuda.host_memory_stats()
    return blocks, after["num_host_alloc"] == before["num_host_alloc"]


def _read_off_card(ds: DataSet, b: torch.Tensor) -> np.ndarray:
    """``b`` (``ds``'s tensor on a card) in host memory, as one
    ``transport.to_host`` span.  The destination is a page-locked block
    of torch's caching host allocator, which serves the whole process:
    once a caller drops its array, the block serves a later read of the
    same size, from any transport.  The array holds its block, so two
    live results never share one.  The span's ``pinned`` says which
    destination was taken, ``reused`` whether the allocator had the
    block cached.  Where :func:`pin_fits` refuses that block or its
    allocation fails, a fresh pageable array, filled on several lanes
    through recycled page-locked staging blocks
    (:func:`_read_staged`): the span then says ``staged``, ``reused``
    of the staging blocks, ``chunks`` and ``lanes``.  One pageable copy
    where the staging blocks are refused too."""
    with _copy_span("transport.to_host", ds, dataset=ds.name,
                    device=str(b.device), pinned=False, reused=False,
                    staged=False) as attrs:
        pinned = _pinned([b.shape], b.dtype)
        if pinned is not None:
            (dst,), reused = pinned
            attrs.update(pinned=True, reused=reused)
            dst.copy_(b.detach())
            out = dst.numpy()
        elif (staged := _read_staged(b.detach())) is not None:
            out, reused, chunks, lanes = staged
            attrs.update(staged=True, reused=reused, chunks=chunks,
                         lanes=lanes)
        else:
            out = to_numpy(b)
        attrs["bytes"] = out.nbytes
    return out


#: bytes of each page-locked staging block of a gather off the slots
#: (:func:`_gather_off_cards`), of a staged read off one card
#: (:func:`_read_staged`) and of a hand-off to the cards
#: (:func:`_stage_to`): a power of two, so torch's caching host
#: allocator takes no more than asked
STAGE_BYTES = 256 << 20

#: the least bytes of a host source that a hand-off to the cards stages
#: (:func:`_stage_to`); a smaller one is the plain copy.  On the H100
#: host a sweep member's 36.9 MB band went no faster staged (5.4-6.4 ms
#: at 4-8 lanes) than pageable (5.7), a 147.5 MB band 2.4 times faster
UPLOAD_BYTES = 64 << 20

#: host threads (lanes) of one hand-off to the cards, at most the host's
#: CPUs, dealt over its slots (one at least each), and of one staged
#: read off a card (:func:`_read_staged`): on the H100 host of 8 CPUs,
#: copies of a warm 147.5 MB band into page-locked memory ran at 5.8
#: GB/s on one thread, 16 on four and 21 on eight; an 18.9 GB volume's
#: staged read into fresh memory at 5.2-5.6 GB/s on 1, 4 or 8 lanes
#: (each lane's copy runs on torch's intra-op threads; the first touch
#: of the pages bounds it), against 2.3 for one pageable copy
UPLOAD_LANES = 8


def stage_rows(shape: Sequence[int], itemsize: int) -> int:
    """How many whole leading rows of a block of ``shape`` one staging
    block of :data:`STAGE_BYTES` holds, at most the block's own; 0 where
    the block does not stage (no leading dim, no bytes, or one row
    larger than a staging block)."""
    if not shape:
        return 0
    row = itemsize * math.prod(shape[1:])
    return 0 if row == 0 else min(shape[0], STAGE_BYTES // row)


def stage_chunks(n: int, rows: int) -> list[tuple[int, int]]:
    """Each chunk's [lo, hi) of ``n`` leading rows taken ``rows`` at a
    time: whole chunks, then what is left."""
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def upload_plan(shape: Sequence[int], itemsize: int, lanes: int
                ) -> list[tuple[int, int]]:
    """Each lane's [lo, hi) of the leading rows of a block of ``shape``
    handed to a card (:func:`_stage_to`) or read off one
    (:func:`_read_staged`): the rows dealt in near-equal runs
    (:func:`split_sizes`) over ``lanes`` lanes, or over the rows where
    there are fewer.  Each lane then takes its run
    :func:`stage_rows` rows at a time.  Empty where a row is larger
    than a staging block."""
    if stage_rows(shape, itemsize) == 0:
        return []
    return _bounds(split_sizes(shape[0], min(lanes, shape[0])))


def _stage_blocks(shapes: Sequence[Sequence[int]], dtype: torch.dtype
                  ) -> tuple[list[list[torch.Tensor]], bool] | None:
    """Page-locked staging blocks for blocks of ``shapes`` (``dtype``):
    each block's :func:`stage_rows` leading rows a staging block, two,
    or one for a block of one chunk, from torch's caching host
    allocator, and whether the allocator had all of them cached.  None
    where a block does not stage, :func:`pin_fits` refuses them, or the
    page-locked allocation fails."""
    per = []
    for shape in shapes:
        rows = stage_rows(shape, dtype.itemsize)
        if rows == 0:
            return None
        per.append([(rows, *shape[1:])] * (2 if shape[0] > rows else 1))
    pinned = _pinned([s for ss in per for s in ss], dtype)
    if pinned is None:
        return None
    stages, reused = pinned
    it = iter(stages)
    return [[next(it) for _ in ss] for ss in per], reused


def _side_stream(device: torch.device):
    """A new stream of CUDA ``device`` that first waits on the calling
    thread's current stream there, where ``device``'s data was made
    (None for the host)."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def _drain(block: torch.Tensor, dst: torch.Tensor,
           stages: Sequence[torch.Tensor], stream) -> int:
    """Copy ``block`` into ``dst`` (a host view of its shape) chunk by
    chunk through ``stages``: while this thread copies chunk i out of
    one staging block, the card copies chunk i + 1 into the other on
    ``stream`` (None: a block in host memory, copied at once).  Returns
    the chunks."""
    chunks = stage_chunks(block.shape[0], stages[0].shape[0])
    pending = collections.deque()

    def launch(i):
        lo, hi = chunks[i]
        stage = stages[i % len(stages)][:hi - lo]
        done = None
        if stream is None:
            stage.copy_(block[lo:hi])
        else:
            with torch.cuda.stream(stream):
                stage.copy_(block[lo:hi], non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        pending.append((stage, done))

    for i in range(min(len(stages), len(chunks))):
        launch(i)
    for i, (lo, hi) in enumerate(chunks):
        stage, done = pending.popleft()
        if done is not None:
            done.synchronize()
        dst[lo:hi].copy_(stage)
        if i + len(stages) < len(chunks):
            launch(i + len(stages))     # into the block just emptied
    return len(chunks)


def _fill(src: np.ndarray, dst: torch.Tensor,
          stages: Sequence[torch.Tensor], stream) -> int:
    """Copy ``src`` (a host array) into ``dst`` (a tensor of its shape)
    chunk by chunk through ``stages``, the reverse of :func:`_drain`:
    while this thread copies chunk i into one staging block, the card
    copies chunk i - 1 out of the other on ``stream`` (None: ``dst`` in
    host memory, copied at once).  A staging block is refilled only
    once its copy to the card has completed, and this returns only once
    the last one has.  Returns the chunks."""
    hosts = [s.numpy() for s in stages]
    done: list[Any] = [None] * len(stages)
    chunks = stage_chunks(src.shape[0], stages[0].shape[0])
    for i, (lo, hi) in enumerate(chunks):
        k = i % len(stages)
        if done[k] is not None:
            done[k].synchronize()
        # numpy's copy releases the interpreter lock, so lanes copy at once
        np.copyto(hosts[k][:hi - lo], src[lo:hi])
        if stream is None:
            dst[lo:hi].copy_(stages[k][:hi - lo])
            continue
        with torch.cuda.stream(stream):
            dst[lo:hi].copy_(stages[k][:hi - lo], non_blocking=True)
            done[k] = torch.cuda.Event()
            done[k].record(stream)
    for ev in done:
        if ev is not None:
            ev.synchronize()
    return len(chunks)


_lanes_lock = threading.Lock()
_lanes: ThreadPoolExecutor | None = None


def _lane_pool() -> ThreadPoolExecutor:
    """The threads that run the lanes of every hand-off to the cards
    (:func:`_fill_all`) and of every staged read off one card
    (:func:`_read_staged`) in the process, made at the first use and
    kept, as the caching host allocator keeps the staging blocks: a
    pool of eight threads made for each band cost 1.5–2.7 ms on the
    H100 host, a fifth of the staged copy.  It makes a thread only when
    none is idle, so concurrent copies do not wait on each other."""
    global _lanes
    with _lanes_lock:
        if _lanes is None:
            _lanes = ThreadPoolExecutor(64, thread_name_prefix="stage-lane")
        return _lanes


def _fill_all(srcs: Sequence[np.ndarray], dsts: Sequence[torch.Tensor],
              stages: Sequence[Sequence[torch.Tensor]]) -> int:
    """Each host array of ``srcs`` into its tensor of ``dsts`` through
    its staging blocks (:func:`_fill`), every one at once, each on a
    lane thread (:func:`_lane_pool`) and on a stream of its own that
    first waits on its device's current stream (where ``dsts`` were
    allocated).  The current streams then wait on those streams, so
    whatever the caller queues next reads the copies.  Returns the
    chunks."""
    streams = [_side_stream(d.device) for d in dsts]
    pool = _lane_pool()
    futures = [pool.submit(_fill, *a)
               for a in zip(srcs, dsts, stages, streams)]
    chunks = sum(f.result() for f in futures)
    for d, stream in zip(dsts, streams):
        if stream is not None:
            torch.cuda.current_stream(d.device).wait_stream(stream)
    return chunks


def _host_array(a) -> np.ndarray | None:
    """``a``'s pageable host memory as a numpy array: a numpy array, or
    a pageable CPU tensor of a dtype numpy has.  None for anything else
    (a device tensor, a page-locked one, a ``ShardedTensor``)."""
    if isinstance(a, np.ndarray):
        return a
    if (isinstance(a, torch.Tensor) and a.device.type == "cpu"
            and not a.is_pinned()):
        try:
            return a.detach().numpy()
        except TypeError:           # bfloat16 and the like
            return None
    return None


def _stage_to(srcs: Sequence[np.ndarray], devices: Sequence[torch.device]
              ) -> tuple[list[torch.Tensor], bool, int] | None:
    """Each host array of ``srcs`` as a tensor on its device of
    ``devices``, every one at once, through recycled page-locked
    staging blocks: :data:`UPLOAD_LANES` lanes (at most the host's
    CPUs) dealt over the arrays, one at least each, each array's rows
    split over its lanes (:func:`upload_plan`), and each lane copying
    its run on a thread of its own through a ring of two staging blocks
    of torch's caching host allocator (:func:`_fill_all`): the host's
    copy is split over threads, and a lane's copy to the card overlaps
    the others' copies on the host.  Returns the tensors, whether every
    staging block came from the allocator's cache, and the chunks; None
    where a row of an array is larger than a staging block or
    :func:`_stage_blocks` refuses, and for fewer bytes in all than
    :data:`UPLOAD_BYTES`."""
    if sum(s.nbytes for s in srcs) < UPLOAD_BYTES:
        return None
    lanes = max(1, min(UPLOAD_LANES, os.cpu_count() or 1) // len(srcs))
    plans = [upload_plan(s.shape, s.itemsize, lanes) for s in srcs]
    if not all(plans):
        return None
    dtype = torch_dtype(srcs[0].dtype)
    staged = _stage_blocks([(hi - lo, *s.shape[1:])
                            for s, runs in zip(srcs, plans)
                            for lo, hi in runs], dtype)
    if staged is None:
        return None
    stages, reused = staged
    outs = [torch.empty(s.shape, dtype=dtype, device=d)
            for s, d in zip(srcs, devices)]
    runs = [(s[lo:hi], o[lo:hi]) for s, o, plan in zip(srcs, outs, plans)
            for lo, hi in plan]
    chunks = _fill_all([r[0] for r in runs], [r[1] for r in runs], stages)
    return outs, reused, chunks


def _read_staged(b: torch.Tensor
                 ) -> tuple[np.ndarray, bool, int, int] | None:
    """``b`` (a tensor on a card) in one fresh pageable host array,
    through recycled page-locked staging blocks: its leading rows dealt
    in near-equal runs over :data:`UPLOAD_LANES` lanes (at most the
    host's CPUs; :func:`upload_plan`), each lane on a thread of
    :func:`_lane_pool`, with a stream of its own and its own staging
    blocks (:func:`_stage_blocks`), copying its run into its own view
    of the array (:func:`_drain`): the card fills one staging block
    while the lane empties the other, so the lanes share the first
    touch of the array's pages.  Returns the array, whether every
    staging block came from the allocator's cache, the chunks and the
    lanes; None where a row is larger than a staging block or
    :func:`_stage_blocks` refuses."""
    plan = upload_plan(b.shape, b.element_size(),
                       min(UPLOAD_LANES, os.cpu_count() or 1))
    if not plan:
        return None
    staged = _stage_blocks([(hi - lo, *b.shape[1:]) for lo, hi in plan],
                           b.dtype)
    if staged is None:
        return None
    stages, reused = staged
    whole = torch.empty(b.shape, dtype=b.dtype)
    streams = [_side_stream(b.device) for _ in plan]
    pool = _lane_pool()
    futures = [pool.submit(_drain, b[lo:hi], whole[lo:hi], s, stream)
               for (lo, hi), s, stream in zip(plan, stages, streams)]
    chunks = sum(f.result() for f in futures)
    return whole.numpy(), reused, chunks, len(plan)


def _gather_off_cards(ds: DataSet, st: ShardedTensor) -> np.ndarray:
    """``st`` (``ds``'s backing on the slots) in host memory, as one
    ``transport.to_host`` span.  The destination is one fresh host
    array, and each slot block is written into its own view of it.
    Every slot is read at once, by a thread of its own, through its
    own page-locked staging blocks (:func:`_stage_blocks`), which the
    caching host allocator keeps for the next gather: the card fills
    one while the thread empties the other, so the slots share the
    first touch of the destination's pages.  The span's ``pinned``
    says whether it staged, ``reused`` whether every staging block came
    from the allocator's cache, ``chunks`` the chunks staged.  The
    pageable gather (:meth:`ShardedTensor.numpy`) where the blocks do
    not stage."""
    blocks = st.blocks()
    with _copy_span("transport.to_host", ds, dataset=ds.name,
                    device=_devices_of(st.devices), slots=len(st.devices),
                    pinned=False, reused=False, chunks=0) as attrs:
        staged = _stage_blocks([b.shape for b in blocks], st.dtype)
        if staged is None:
            out = st.numpy()
        else:
            stages, reused = staged
            whole = torch.empty(st.shape, dtype=st.dtype)
            dsts = ([whole] if st.dim is None else
                    [whole.narrow(st.dim, lo, hi - lo)
                     for lo, hi in st._spans()])
            streams = [_side_stream(b.device) for b in blocks]
            with ThreadPoolExecutor(len(blocks)) as pool:
                futures = [pool.submit(_drain, *a)
                           for a in zip(blocks, dsts, stages, streams)]
                chunks = sum(f.result() for f in futures)
            out = whole.numpy()
            attrs.update(pinned=True, reused=reused, chunks=chunks)
        attrs["bytes"] = out.nbytes
    return out


def _bounds(sizes: Sequence[int]) -> list[tuple[int, int]]:
    """Each block's [lo, hi) when blocks of ``sizes`` follow each other."""
    out, at = [], 0
    for n in sizes:
        out.append((at, at + n))
        at += n
    return out


class ShardedTensor:
    """A dataset's backing on a :class:`ShardedTransport` between steps:
    one tensor per slot, each the slot's block along ``dim`` (slot order
    is block order), or each a whole copy when ``dim`` is None
    (replicated).  ``shape`` and ``dtype`` are the whole's; ``to`` and
    ``numpy`` gather it with one copy per slot block, never through a
    copy of the whole on another device first."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int | None,
                 devices: Sequence[torch.device]):
        self.shards = list(shards)
        self.dim = dim
        self.devices = tuple(devices)

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.shards[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(t.shape[self.dim] for t in self.shards)
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def blocks(self) -> list[torch.Tensor]:
        """The slot blocks whose concatenation along ``dim`` is the
        whole (one replica when replicated)."""
        return self.shards[:1] if self.dim is None else self.shards

    def to(self, device) -> torch.Tensor:
        """The whole as one tensor on ``device``: each slot block copied
        into its place in one allocation (no second copy of the whole
        through a concatenation)."""
        blocks = self.blocks()
        if len(blocks) == 1:
            return blocks[0].to(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for t, (lo, hi) in zip(blocks, self._spans()):
            out.narrow(self.dim, lo, hi - lo).copy_(t)
        return out

    def numpy(self) -> np.ndarray:
        return self.to("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def leading_blocks(self) -> list[torch.Tensor]:
        """Tensors whose concatenation along dim 0 is the whole, in
        order: the slot blocks when the split is along dim 0 (or none),
        else the whole gathered to the host."""
        if self.dim in (0, None):
            return self.blocks()
        return [self.to("cpu")]

    def _spans(self) -> list[tuple[int, int]]:
        """Each slot block's [lo, hi) along ``dim``."""
        return _bounds([t.shape[self.dim] for t in self.shards])

    def read_region(self, axis: int, lo: int, hi: int) -> torch.Tensor:
        """Entries [lo, hi) along ``axis``, as one tensor on the first
        slot's device."""
        if self.dim is None:
            return self.shards[0].narrow(axis, lo, hi - lo)
        parts = []
        for t, (a, b) in zip(self.shards, self._spans()):
            if axis != self.dim:
                parts.append(t.narrow(axis, lo, hi - lo))
            elif max(a, lo) < min(b, hi):
                parts.append(t.narrow(axis, max(a, lo) - a,
                                      min(b, hi) - max(a, lo)))
        parts = [p.to(self.devices[0]) for p in parts]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)

    def write_region(self, axis: int, lo: int, hi: int, values) -> None:
        """Write ``values`` (the whole's entries [lo, hi) along
        ``axis``) into the slot blocks, in place."""
        values = to_tensor(values, self.devices[0])
        if self.dim is None:
            for t in self.shards:
                t.narrow(axis, lo, hi - lo).copy_(values)
            return
        for t, (a, b) in zip(self.shards, self._spans()):
            if axis != self.dim:
                t.narrow(axis, lo, hi - lo).copy_(
                    values.narrow(self.dim, a, b - a))
            elif max(a, lo) < min(b, hi):
                s, e = max(a, lo), min(b, hi)
                t.narrow(axis, s - a, e - s).copy_(
                    values.narrow(axis, s - lo, e - s))

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"dim={self.dim}, slots={[str(d) for d in self.devices]})")


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _device_consts(plugin: BasePlugin, device: torch.device
                   ) -> dict[str, Any]:
    """The plugin's :meth:`jit_constants`, arrays moved to ``device``."""
    return {k: to_tensor(v, device) if _is_array(v) else v
            for k, v in plugin.jit_constants().items()}


def _same_consts(all_consts: Sequence[dict[str, Any]]) -> bool:
    """True when every member's constants equal the first's (same keys,
    equal tensors, equal scalars)."""
    c0 = all_consts[0]
    for c in all_consts[1:]:
        if c.keys() != c0.keys():
            return False
        for k, v in c0.items():
            w = c[k]
            if isinstance(v, torch.Tensor):
                if not (isinstance(w, torch.Tensor) and v.shape == w.shape
                        and v.dtype == w.dtype and torch.equal(v, w)):
                    return False
            elif v != w:
                return False
    return True


def _with_consts(plugin: BasePlugin, consts: dict[str, Any]) -> BasePlugin:
    """A shallow copy of ``plugin`` with ``consts`` bound: a built step
    is shared by every plugin instance with its key, and several jobs'
    threads may run it at once, so each call binds its constants on a
    copy of its own rather than on the shared instance."""
    bound = copy.copy(plugin)
    for k, v in consts.items():
        setattr(bound, k, v)
    return bound


@dataclasses.dataclass(frozen=True)
class _StepSpec:
    """What a built step keeps of the plugin it was built for: the
    patterns, the outputs' shapes and dtypes, the frames a call takes,
    and a copy of the plugin without its datasets or constants.  A
    built step is shared by every later plugin instance with its key,
    so it holds none of the data that the first instance ran on."""

    plugin: BasePlugin
    in_pats: tuple[Pattern, ...]
    out_pats: tuple[Pattern, ...]
    out_shapes: tuple[tuple[int, ...], ...]
    out_dtypes: tuple[torch.dtype, ...]
    m: int


def _step_spec(plugin: BasePlugin) -> _StepSpec:
    bare = copy.copy(plugin)
    bare.in_data, bare.out_data = [], []
    for k in plugin.jit_constants():
        setattr(bare, k, None)       # each call binds its own
    return _StepSpec(
        bare, tuple(pd.pattern for pd in plugin.in_data),
        tuple(pd.pattern for pd in plugin.out_data),
        tuple(pd.dataset.shape for pd in plugin.out_data),
        tuple(torch_dtype(pd.dataset.dtype) for pd in plugin.out_data),
        plugin.in_data[0].n_frames if plugin.in_data else 1)


def frame_budget(device: torch.device, need: int) -> int | None:
    """The bytes a per-frame step's declared working set may take on
    ``device`` at once, for a stack that declares ``need`` bytes: a
    quarter of what the card has free, counting the blocks torch's
    caching allocator holds unused.  The rest leaves room for the
    outputs and for what a declaration leaves out: the spectrum scale's
    step holds about 1.7 times its three declared buffers at once (the
    inverse transform's copy of its input, cuFFT's work area), so at a
    third its blocks of a card's share of the whole scan peaked at 61 of
    80 GB.  None (no limit) off a card, and for a stack that needs at
    most a sixteenth of the card: it fits unless the card is already
    three quarters full, and asking the CUDA driver what is free costs
    each small step milliseconds of an idle card."""
    if device.type != "cuda" or 16 * need <= \
            torch.cuda.get_device_properties(device).total_memory:
        return None
    free, _ = torch.cuda.mem_get_info(device)
    unused = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return (free + unused) // 4


def _per_frame(bound: BasePlugin, frames: Sequence[torch.Tensor]
               ) -> list[torch.Tensor]:
    """``process_frames`` of a per-frame plugin over the whole frame
    stack: in one call when the plugin's declared working set
    (:meth:`BasePlugin.frame_bytes`) for every frame fits
    :func:`frame_budget`, else in blocks of frames that each fit, every
    block's outputs written into outputs allocated once.  Notes the
    blocks it ran (:func:`~repro_torch.kernels.tally.note_blocks`)."""
    nf = frames[0].shape[0]
    per = bound.frame_bytes([tuple(f.shape[1:]) for f in frames])
    budget = frame_budget(frames[0].device, nf * per) if per else None
    k = nf if budget is None else max(1, min(nf, budget // per))
    if k >= nf:
        note_blocks(1)
        return _as_list(bound.process_frames(frames))
    outs: list[torch.Tensor] = []
    for s in range(0, nf, k):
        res = _as_list(bound.process_frames([f[s:s + k] for f in frames]))
        if not outs:
            outs = [r.new_empty((nf,) + tuple(r.shape[1:])) for r in res]
        for o, r in zip(outs, res):
            o[s:s + r.shape[0]].copy_(r)
        del res
    note_blocks(-(-nf // k))
    return outs


class GangSignatureMismatch(ValueError):
    """The members of a gang step do not share one built step (shapes,
    dtypes, constants' structure or plugin identity differ): run them
    one by one.  Any other error inside a gang step fails the gang."""


class Transport:
    """Interface: allocate out-dataset backing + run one plugin."""

    name = "base"

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)

    def allocate(self, ds: DataSet, now: Pattern, next_: Pattern | None
                 ) -> None:
        raise NotImplementedError

    def run_plugin(self, plugin: BasePlugin) -> list[Any]:
        """Execute plugin.process_frames over all frames.  The plugin's
        PluginData views (in_data/out_data) define patterns + m."""
        raise NotImplementedError

    def read(self, ds: DataSet) -> np.ndarray:
        """Materialise a dataset to host numpy (tests / savers)."""
        return to_numpy(ds.materialise())

    def run_window(self, plugin: BasePlugin, slabs: Sequence[Any],
                   out_shapes: Sequence[tuple[int, ...]]) -> list[Any]:
        """Streaming: ``process_frames`` over one slab of newly arrived
        frames (a windowed plugin: ``n_frames == 1``, every frame
        independent), in one call on this transport's device.  ``slabs``
        are the plugin's inputs cut to the slab along the arrival axis;
        returns its outputs of ``out_shapes``, which the runner writes
        into the growing datasets."""
        self._check_driver(plugin)
        frames = [pd.pattern.to_frames(to_tensor(s, self.device))
                  for pd, s in zip(plugin.in_data, slabs)]
        res = _as_list(_with_consts(
            plugin, _device_consts(plugin, self.device)).process_frames(
                frames))
        outs = [pd.pattern.from_frames(r, shp).to(
                    torch_dtype(pd.dataset.dtype))
                for pd, r, shp in zip(plugin.out_data, res, out_shapes)]
        self._sync()
        return outs

    def plugin_cost(self, *plugins: BasePlugin) -> dict[str, float] | None:
        """Work and memory of one plugin step, or of the gang step of
        several plugins, measured before the step is timed: None where
        the transport does not measure them."""
        return None

    def stats(self) -> dict[str, Any]:
        return {}

    def close(self) -> None:
        pass

    def _check_driver(self, plugin: BasePlugin) -> None:
        if not plugin.driver.allows(self.device):
            raise RuntimeError(
                f"plugin {plugin.name!r} runs on {plugin.driver.devices}, "
                f"not on this transport's device {str(self.device)!r}")

    def _sync(self) -> None:
        # the profiler's process span must cover device work, not the
        # enqueue
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class LocalCompileCache:
    """Minimal per-transport step cache (duck type ``get_or_build`` +
    ``stats``, the interface a process-level cache would share)."""

    def __init__(self):
        self._entries: dict = {}
        self._costs: dict = {}
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key, builder):
        try:
            fn = self._entries[key]
            self.hits += 1
            return fn
        except KeyError:
            self.misses += 1
            t0 = time.time()
            fn = self._entries[key] = builder()
            tr = current_trace()
            if tr is not None:
                tr.record("compile", t0, time.time(),
                          attrs={"kind": key[0] if isinstance(key, tuple)
                                 and key else "plugin"})
            return fn

    def cost(self, key, measure):
        """The cost profile of step ``key``, ``measure()`` on a miss."""
        if key not in self._costs:
            self._costs[key] = measure()
        return self._costs[key]

    def stats(self) -> dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


class _PeakMemory(TorchDispatchMode):
    """Peak bytes on ``device`` of the tensors that the ops run under it
    allocate and that are alive at once.  A storage counts from the op
    that returns it until it is freed; a storage
    that existed before (an input, or what a view of it shares) never
    counts, nor does what a library op allocates and frees inside itself
    (cuFFT's work area).  Dispatch modes are per thread, so what other
    threads allocate meanwhile never enters the reading.  Ops on DTensors
    are deferred to DTensor, so the reading is of the local shards (the
    dry-run's per-device memory)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        # storage -> a weak reference whose callback, run when the
        # storage is freed, takes its bytes off ``now``: no op walks the
        # live storages (a 32k-step recurrence holds as many)
        self._seen: dict[int, weakref.ref] = {}
        self.now = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented      # read the local shards beneath it
        for t in tree_leaves((args, kwargs)):
            self._see(t, count=False)
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            self._see(t, count=True)
        self.peak = max(self.peak, self.now)
        return out

    def _see(self, t, count: bool) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = StorageWeakRef(st).cdata
        if key in self._seen:
            return
        dev = t.device
        n = st.nbytes() if count and dev.type == self.device.type and (
            self.device.index is None or dev.index == self.device.index) \
            else 0

        def freed(_, key=key, n=n):
            self._seen.pop(key, None)
            self.now -= n

        # a storage's Python object lives as long as the storage does
        self._seen[key] = weakref.ref(st, freed)
        self.now += n


# ======================================================================
class InMemoryTransport(Transport):
    """Serial PC mode — host storage, a loop over groups of m frames."""

    name = "inmemory"

    def allocate(self, ds: DataSet, now, next_) -> None:
        ds.backing = np.zeros(ds.shape, dtype=ds.dtype)

    def run_plugin(self, plugin: BasePlugin) -> list[Any]:
        self._check_driver(plugin)
        ins = [to_numpy(pd.dataset.materialise()) for pd in plugin.in_data]
        in_pats = [pd.pattern for pd in plugin.in_data]
        out_pats = [pd.pattern for pd in plugin.out_data]
        m = plugin.in_data[0].n_frames if plugin.in_data else 1

        in_frames = [p.to_frames(a) for p, a in zip(in_pats, ins)]
        nf = in_frames[0].shape[0]
        out_accum: list[list[np.ndarray]] = [[] for _ in plugin.out_data]
        bound = _with_consts(plugin, _device_consts(plugin, self.device))
        for start in range(0, nf, m):
            blocks = [to_tensor(f[start:start + m], self.device)
                      for f in in_frames]
            res = _as_list(bound.process_frames(blocks))
            for i, r in enumerate(res):
                out_accum[i].append(to_numpy(r))
        outs = []
        for pd, pieces, pat in zip(plugin.out_data, out_accum, out_pats):
            flat = np.concatenate(pieces, axis=0)
            outs.append(np.asarray(pat.from_frames(flat, pd.dataset.shape)))
        for pd, o in zip(plugin.out_data, outs):
            pd.dataset.backing = o.astype(pd.dataset.dtype, copy=False)
        return outs


# ======================================================================
class CudaTransport(Transport):
    """One-device mode — datasets stay on the device as tensors; each plugin
    step is built once per :meth:`_plugin_key`, with its
    :meth:`~BasePlugin.jit_constants` handed to it moved to the device;
    an input is dropped at its final use (``PluginData.last_use``)."""

    name = "cuda"

    def __init__(self, device: str | torch.device = "cuda",
                 compile_cache=None, cost_analysis: bool = False):
        super().__init__(device)
        self.compile_cache = (compile_cache if compile_cache is not None
                              else LocalCompileCache())
        #: when True, :meth:`plugin_cost` runs each distinct step once
        #: per compile cache (once per process in the service) before its
        #: timer to count its work and memory (per-step cost profiles on
        #: the ``process`` spans)
        self.cost_analysis = cost_analysis

    def allocate(self, ds: DataSet, now: Pattern, next_: Pattern | None
                 ) -> None:
        ds.backing = None          # step outputs allocate themselves

    def _plugin_fn(self, plugin: BasePlugin):
        """Step ``(consts, *tensors) -> outs``.  ``consts`` are passed as
        arguments, so a built step can be replayed for another plugin
        instance with the same key (same chain, new dataset); it keeps
        only :func:`_step_spec`'s data-free description."""
        spec = _step_spec(plugin)

        def step(consts, *arrays, shapes=None):
            # ``shapes``: the outputs' shapes when the inputs are a
            # streaming slab or a slot's share rather than the whole
            # datasets
            bound = _with_consts(spec.plugin, consts)
            frames = [p.to_frames(a) for p, a in zip(spec.in_pats, arrays)]
            if spec.m == 1:
                res = _per_frame(bound, frames)
            else:
                nf = frames[0].shape[0]
                groups = [_as_list(bound.process_frames(
                    [f[s:s + spec.m] for f in frames]))
                    for s in range(0, nf, spec.m)]
                res = [torch.cat(parts) for parts in zip(*groups)]
            return tuple(pat.from_frames(r, shp).to(dt)
                         for r, pat, shp, dt in zip(
                             res, spec.out_pats, shapes or spec.out_shapes,
                             spec.out_dtypes))

        return step

    def _batch_fn(self, plugin: BasePlugin):
        """Gang step ``(all_consts, members) -> per-member outs`` for
        :meth:`run_plugin_batch`: a per-frame plugin (``n_frames == 1``)
        runs ONCE over the members' frames stacked along the frame axis,
        with the shared constants when every member's agree, or through
        the plugin's ``process_frames_batched`` hook, which takes every
        member's constants and frame count, when they differ
        (:meth:`_gang_check` refuses any other gang)."""
        spec = _step_spec(plugin)

        def step(all_consts, members, shapes=None):
            # ``shapes``: each member's outputs' shapes when the inputs
            # are a slot's share rather than the whole datasets
            frames = [[p.to_frames(a) for p, a in zip(spec.in_pats, arrays)]
                      for arrays in members]
            counts = [f[0].shape[0] for f in frames]
            stacked = [torch.cat(col) for col in zip(*frames)]
            del frames
            if _same_consts(all_consts):
                res = _as_list(_with_consts(
                    spec.plugin, all_consts[0]).process_frames(stacked))
            else:
                res = _as_list(spec.plugin.process_frames_batched(
                    stacked, all_consts, counts))
            del stacked
            per_out = [torch.split(r, counts) for r in res]
            return [tuple(pat.from_frames(parts[j], shp).to(dt)
                          for parts, pat, shp, dt in zip(
                              per_out, spec.out_pats,
                              shapes or spec.out_shapes, spec.out_dtypes))
                    for j in range(len(members))]

        return step

    def _plugin_key(self, plugin: BasePlugin,
                    consts: dict | None = None) -> tuple:
        """Step-cache key: plugin static identity, in/out dataset specs,
        consts structure, driver and where the step runs."""
        def pd_meta(pd):
            return (pd.dataset.shape, str(np.dtype(pd.dataset.dtype)),
                    pd.pattern_name, pd.n_frames)
        if consts is None:
            consts = plugin.jit_constants()
        cmeta = tuple(
            (k, tuple(v.shape), str(v.dtype)) if _is_array(v)
            else (k, (), type(v).__name__)
            for k, v in sorted(consts.items()))
        return ("plugin", plugin.cache_signature(),
                tuple(pd_meta(pd) for pd in plugin.in_data),
                tuple(pd_meta(pd) for pd in plugin.out_data),
                cmeta, plugin.driver, self._where())

    def _where(self) -> tuple[str, ...]:
        """The devices a step runs on, for its key."""
        return (str(self.device),)

    def _to_device(self, ds: DataSet, a) -> torch.Tensor:
        """``a`` (``ds``'s data, or a slab of it) as a tensor on the
        transport's device, inside a ``transport.to_device`` span
        (:func:`_to_device_span`).  A pageable host source of at least
        :data:`UPLOAD_BYTES` bound for a card goes through recycled
        page-locked staging blocks, its rows split over several host
        threads, each lane's copy to the card overlapping the others'
        copies on the host (:func:`_stage_to`); the span then says
        ``staged``, ``reused`` and ``chunks``, and ends when the last
        chunk is on the card.  Anything else is the plain copy
        (:func:`to_tensor`): a smaller source, a device or page-locked
        tensor, a copy to the host, and a source whose staging blocks
        the host cannot give."""
        with _to_device_span(ds, a, self.device) as attrs:
            src = _host_array(a) if self.device.type == "cuda" else None
            staged = None if src is None else _stage_to([src], [self.device])
            if staged is None:
                return to_tensor(a, self.device)
            (out,), reused, chunks = staged
            attrs.update(staged=True, reused=reused, chunks=chunks)
            return out

    def read(self, ds: DataSet) -> np.ndarray:
        """``ds`` in host memory; a copy off the device (or off every
        slot, as one gather) is a ``transport.to_host`` span.  Off a
        card the destination is a recycled page-locked block
        (:func:`_read_off_card`); off the slots' cards the slots are
        read at once through recycled page-locked staging blocks
        (:func:`_gather_off_cards`)."""
        b = ds.materialise()
        if isinstance(b, torch.Tensor):
            if b.device.type == "cuda":
                return _read_off_card(ds, b)
            where = {"device": str(b.device)}
        elif isinstance(b, ShardedTensor):
            if all(t.device.type == "cuda" for t in b.blocks()):
                return _gather_off_cards(ds, b)
            where = {"device": _devices_of(b.devices),
                     "slots": len(b.devices)}
        else:
            return to_numpy(b)
        # the destination is a fresh pageable array
        with _copy_span("transport.to_host", ds, dataset=ds.name,
                        pinned=False, **where) as attrs:
            out = to_numpy(b)
            attrs["bytes"] = out.nbytes
        return out

    def _device_in(self, plugin: BasePlugin) -> list[torch.Tensor]:
        arrays = []
        for pd in plugin.in_data:
            t = self._to_device(pd.dataset, pd.dataset.materialise())
            if not pd.last_use:
                pd.dataset.backing = t     # later consumers reuse the copy
            arrays.append(t)
        return arrays

    def _release(self, plugin: BasePlugin) -> None:
        """Drop device inputs at their final use (the donation rule)."""
        outs = {id(pd.dataset) for pd in plugin.out_data}
        for pd in plugin.in_data:
            if pd.last_use and id(pd.dataset) not in outs and isinstance(
                    pd.dataset.backing, (torch.Tensor, ShardedTensor)):
                # every slot's shard goes at once, never one slot's
                pd.dataset.backing = None

    def run_plugin(self, plugin: BasePlugin) -> list[Any]:
        self._check_driver(plugin)
        arrays = self._device_in(plugin)
        consts = _device_consts(plugin, self.device)
        step = self.compile_cache.get_or_build(
            self._plugin_key(plugin, consts),
            lambda: self._plugin_fn(plugin))
        outs = list(step(consts, *arrays))
        del arrays
        for pd, o in zip(plugin.out_data, outs):
            pd.dataset.backing = o
        self._release(plugin)
        self._sync()
        return outs

    def run_window(self, plugin: BasePlugin, slabs: Sequence[Any],
                   out_shapes: Sequence[tuple[int, ...]]) -> list[Any]:
        """Streaming slab through the SAME built step as
        :meth:`run_plugin` (keyed on the whole datasets, never on the
        slab's length, so random slab sizes add no cache entries)."""
        self._check_driver(plugin)
        consts = _device_consts(plugin, self.device)
        step = self.compile_cache.get_or_build(
            self._plugin_key(plugin, consts),
            lambda: self._plugin_fn(plugin))
        outs = list(step(consts, *[self._to_device(pd.dataset, s)
                                   for pd, s in zip(plugin.in_data, slabs)],
                         shapes=out_shapes))
        self._sync()
        return outs

    def _gang_check(self, plugins: Sequence[BasePlugin],
                    all_consts: Sequence[dict[str, Any]]) -> tuple:
        """The gang's step key; raises :class:`GangSignatureMismatch`
        when the members cannot run as one call: their step keys
        (:meth:`_plugin_key`) differ, the plugin takes several frames a
        call, or their constants differ and the plugin has no
        ``process_frames_batched`` hook."""
        p0 = plugins[0]
        k0 = self._plugin_key(p0, all_consts[0])
        for p, c in zip(plugins[1:], all_consts[1:]):
            if self._plugin_key(p, c) != k0:
                raise GangSignatureMismatch(
                    f"run_plugin_batch: plugin {p.name} does not match "
                    f"the batch signature of {p0.name}")
        if p0.in_data and p0.in_data[0].n_frames != 1:
            raise GangSignatureMismatch(
                f"run_plugin_batch: {p0.name} takes "
                f"{p0.in_data[0].n_frames} frames a call; only per-frame "
                f"plugins fold the job axis into the frame axis")
        if p0.process_frames_batched is None \
                and not _same_consts(all_consts):
            raise GangSignatureMismatch(
                f"run_plugin_batch: the members' constants of {p0.name} "
                f"differ and it has no process_frames_batched hook")
        return k0

    def run_plugin_batch(self, plugins: Sequence[BasePlugin]) -> None:
        """Gang execution: the SAME plugin step of several jobs as one
        call over all members' datasets (the JAX package vmaps its step
        over a stacked job axis; here the job axis folds into the frame
        axis, so a hand-written kernel launches once for the gang).  A
        gang that cannot run as one call (:meth:`_gang_check`) raises
        :class:`GangSignatureMismatch` and the scheduler runs the
        members solo, counting it."""
        all_consts = [_device_consts(p, self.device) for p in plugins]
        k0 = self._gang_check(plugins, all_consts)
        for p in plugins:
            self._check_driver(p)
        step = self.compile_cache.get_or_build(
            ("batch", k0), lambda: self._batch_fn(plugins[0]))
        members = [self._device_in(p) for p in plugins]
        outs = step(all_consts, members)
        del members
        for p, o in zip(plugins, outs):
            for pd, t in zip(p.out_data, o):
                pd.dataset.backing = t
            self._release(p)
        self._sync()

    def plugin_cost(self, *plugins: BasePlugin) -> dict[str, float] | None:
        """Work and memory of one plugin step, or of the gang step of
        several plugins: ``flops`` and ``bytes_accessed`` (and ``bytes``,
        the reference's legacy alias) are the kernels' ``cost()`` counts
        for what the step computes, whichever route computed it, plus
        what ``FlopCounterMode`` counts of its library ops;
        ``peak_memory`` is the most memory on the transport's device that
        the tensors the step allocates hold at once (:class:`_PeakMemory`).

        Measured by one run of the step before its timer starts (the
        counterpart of the JAX package's ahead-of-time
        ``cost_analysis``), cached per step key in the compile cache, so
        the transports that share one cache (the service's jobs) measure
        each distinct step once.  None when ``cost_analysis`` is off or
        the step cannot be costed: telemetry never decides how the step
        itself runs."""
        if not self.cost_analysis:
            return None
        try:
            all_consts = [_device_consts(p, self.device) for p in plugins]
            if len(plugins) == 1:
                key = ("cost", self._plugin_key(plugins[0], all_consts[0]))
            else:
                key = ("cost", len(plugins), _same_consts(all_consts),
                       self._gang_check(plugins, all_consts))
        except Exception:          # noqa: BLE001 — telemetry only
            return None

        def measure():
            try:
                return self._measure(plugins, all_consts)
            except Exception:      # noqa: BLE001 — telemetry only
                return None

        return self.compile_cache.cost(key, measure)

    def _measure(self, plugins: Sequence[BasePlugin],
                 all_consts: list[dict[str, Any]]) -> dict[str, float]:
        with tally(costs=True) as t, FlopCounterMode(display=False) as fc, \
                _PeakMemory(self.device) as mem:
            members, shapes = self._measured_inputs(plugins)
            if len(plugins) == 1:
                p = plugins[0]
                step = self.compile_cache.get_or_build(
                    self._plugin_key(p, all_consts[0]),
                    lambda: self._plugin_fn(p))
                outs = step(all_consts[0], *members[0], shapes=shapes)
            else:
                step = self.compile_cache.get_or_build(
                    ("batch", self._plugin_key(plugins[0], all_consts[0])),
                    lambda: self._batch_fn(plugins[0]))
                outs = step(all_consts, members, shapes=shapes)
            del outs, members
        self._sync()
        return {"flops": t.flops + float(fc.get_total_flops()),
                "bytes": t.bytes, "bytes_accessed": t.bytes,
                "peak_memory": float(mem.peak)}

    def _measured_inputs(self, plugins: Sequence[BasePlugin]) -> tuple:
        """The inputs of the step that :meth:`_measure` runs, per
        plugin, and the outputs' shapes (None: the datasets')."""
        return [self._device_in(p) for p in plugins], None

    def stats(self) -> dict[str, Any]:
        return {"compile_cache": self.compile_cache.stats()}


# ======================================================================
def _slot_devices(devices) -> tuple[torch.device, ...]:
    """A :class:`ShardedTransport`'s slots: ``"all"`` is every visible
    card in index order; a sequence names each slot's device, repeats
    allowed.  A device that does not exist raises; none is remapped."""
    if isinstance(devices, str):
        if devices != "all":
            raise ValueError(f"devices is 'all' or a sequence of devices, "
                             f"got {devices!r}")
        resolve_device("cuda")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    slots = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev.index >= torch.cuda.device_count():
                raise ValueError(
                    f"slot {len(slots)}: {dev} does not exist (this host "
                    f"has {torch.cuda.device_count()} card(s))")
        slots.append(dev)
    if not slots:
        raise ValueError("a ShardedTransport needs at least one slot")
    if len({d.type for d in slots}) > 1:
        raise ValueError(f"slots {[str(d) for d in slots]} mix device "
                         f"types")
    return tuple(slots)


def slots_on(device: str | torch.device = "cuda",
             n: int | None = None) -> tuple[torch.device, ...]:
    """The slots the entry points' ``--slots`` names: ``n`` repeats of
    ``device``; with ``n`` None, every visible card for ``"cuda"`` and
    one slot otherwise."""
    dev = resolve_device(device)
    if n is None:
        return _slot_devices("all" if dev == torch.device("cuda")
                             else (dev,))
    if n < 1:
        raise ValueError(f"slots must be >= 1, got {n}")
    return _slot_devices((dev,) * n)


def split_sizes(n: int, k: int) -> list[int]:
    """``n`` entries dealt over ``k`` slots as Savu's MPI mode deals
    frames to its processes: ``n // k`` each, and one more to each of
    the first ``n % k`` slots, in slot order."""
    q, r = divmod(n, k)
    return [q + 1 if j < r else q for j in range(k)]


def _narrow(a, dim: int, lo: int, n: int):
    """Entries [lo, lo + n) of ``a`` (array or tensor) along ``dim``."""
    return a[(slice(None),) * dim + (slice(lo, lo + n),)]


class ShardedTransport(CudaTransport):
    """Savu's MPI mode on several slots: the JAX package's
    ``ShardedTransport``, with one process driving the slots as the
    reference's single controller drives its mesh.

    Between steps a dataset is a :class:`ShardedTensor` split along its
    pattern's first slice dim over the slots (:meth:`Pattern.to_spec` on
    the plugin driver's data axis).  Every slot runs the plugin's built
    step (:meth:`CudaTransport._plugin_fn`) on its share, so each kernel
    launches once per slot, on the slot's device.  Where the next
    plugin's pattern splits another dim, its input is re-split first:
    an all-to-all in which each slot sends each other slot its block
    with ``Tensor.to(device, non_blocking=True)`` (a peer copy between
    cards, a device-local copy between slots of one card), never through
    the host.  A plugin with no data axis, or with a dataset its pattern
    does not split, runs once on the first slot, and its outputs are
    placed on every slot (the reference's all-``None`` spec).

    ``devices``: ``"all"`` (every visible card, in index order) or a
    sequence of devices, repeats allowed (``("cuda:0",) * 4`` on one
    card, ``("cpu",) * 4`` in the tests); slots on one device compute
    apart exactly as slots on different cards do.  A split that does
    not divide gives the first slots one entry more
    (:func:`split_sizes`), as Savu's MPI mode gives its processes
    unequal frame counts; the reference's ``device_put`` refuses it.
    Only a dim shorter than the slot count raises.  Streaming windows
    run on the first slot, where the growing datasets live; barrier
    steps run sharded.  :meth:`plugin_cost`
    counts one slot's step, as the reference's cost analysis of an SPMD
    program is per device."""

    name = "sharded"
    #: the mesh axis the slots form
    axis = "data"

    def __init__(self, devices: str | Sequence = "all", compile_cache=None,
                 cost_analysis: bool = False):
        self.slots = _slot_devices(devices)
        super().__init__(self.slots[0], compile_cache, cost_analysis)
        #: re-splits from one split to another (the all-to-alls, and
        #: gathers for a replicated step), the bytes that crossed between
        #: slots, and their seconds (host clock, ending in a synchronise
        #: of every slot)
        self.alltoalls = 0
        self.alltoall_bytes = 0
        self.alltoall_s = 0.0

    def _where(self) -> tuple[str, ...]:
        return tuple(str(d) for d in self.slots)

    def _sync(self) -> None:
        for d in dict.fromkeys(self.slots):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- placement -------------------------------------------------------
    def _split_dim(self, ds: DataSet, pattern: Pattern,
                  data_axis: str | None = "data") -> int | None:
        """The dim of ``ds`` that ``pattern`` splits over the slots (None:
        replicated); ``data_axis`` is the plugin driver's."""
        spec = pattern.to_spec(data_axis if data_axis == self.axis
                               else None)
        dims = [d for d, ax in enumerate(spec) if ax == self.axis]
        if len(dims) > 1:
            raise ValueError(
                f"dataset {ds.name!r}: pattern {pattern.name!r} puts dims "
                f"{dims} on the {self.axis!r} axis; at most one may be")
        if dims and dims[0] in pattern.core_dims:
            raise ValueError(
                f"dataset {ds.name!r}: pattern {pattern.name!r} splits "
                f"core dim {dims[0]}; a slot computes on whole frames")
        return dims[0] if dims else None

    def _local(self, name: str, shape: Sequence[int], dim: int | None,
               slot: int = 0) -> tuple[int, ...]:
        """Slot ``slot``'s share of ``shape`` split along ``dim``."""
        return self._shares(name, shape, dim)[slot]

    def _shares(self, name: str, shape: Sequence[int],
                dim: int | None) -> list[tuple[int, ...]]:
        """Every slot's share of ``shape`` split along ``dim``
        (:func:`split_sizes`)."""
        shape = tuple(shape)
        n = len(self.slots)
        if dim is None:
            return [shape] * n
        if 0 < shape[dim] < n:
            raise ValueError(
                f"dataset {name!r}: dim {dim} of size {shape[dim]} does not "
                f"split over {n} slots (a slot would get no entry)")
        return [shape[:dim] + (k,) + shape[dim + 1:]
                for k in split_sizes(shape[dim], n)]

    def _slot_bounds(self, name: str, shape: Sequence[int],
                     dim: int) -> list[tuple[int, int]]:
        """Each slot's [lo, hi) along ``dim`` of ``shape``."""
        return _bounds([sh[dim] for sh in self._shares(name, shape, dim)])

    def _scatter(self, a, dim: int | None, name: str,
                 ds: DataSet | None = None) -> ShardedTensor:
        """A host array or one-device tensor as slot blocks; the scatter
        of ``ds``'s host data is one ``transport.to_device`` span.  A
        pageable host source of at least :data:`UPLOAD_BYTES` bound for
        the slots' cards feeds every slot at once, the lanes dealt over
        the slots, through page-locked staging blocks of
        :data:`STAGE_BYTES`, the blocks the gather off the slots leaves
        cached (:func:`_stage_to`), and the span says ``staged``,
        ``reused`` and ``chunks``; else each slot block is the plain
        copy, slot after slot."""
        def cut(x):
            return ([x] * len(self.slots) if dim is None else
                    [_narrow(x, dim, lo, hi - lo)
                     for lo, hi in self._slot_bounds(name, x.shape, dim)])

        blocks = cut(a)
        with _to_device_span(ds, a, self.device,
                             bytes=sum(_nbytes(b) for b in blocks),
                             device=_devices_of(self.slots),
                             slots=len(self.slots)) as attrs:
            src = (_host_array(a) if all(d.type == "cuda" for d in self.slots)
                   else None)
            staged = None if src is None else _stage_to(cut(src), self.slots)
            if staged is None:
                return ShardedTensor([to_tensor(b, dev).contiguous()
                                      for b, dev in zip(blocks, self.slots)],
                                     dim, self.slots)
            shards, reused, chunks = staged
            attrs.update(staged=True, reused=reused, chunks=chunks)
            return ShardedTensor(shards, dim, self.slots)

    def _replicate(self, t: torch.Tensor) -> ShardedTensor:
        return ShardedTensor([t.to(dev) for dev in self.slots], None,
                             self.slots)

    def _resplit(self, st: ShardedTensor, dim: int | None, ds: DataSet,
                 record: bool = True) -> ShardedTensor:
        """``st`` (``ds``'s backing) split along ``dim`` over the slots.
        From one split dim to another this is the all-to-all: slot i's
        block j goes to slot j.  From replicated each slot cuts its own
        replica; to replicated every slot gathers every block.  With
        ``record``, a move between slots is counted (``stats()``) and
        is one ``transport.alltoall`` span on ``ds``'s trace (attrs
        ``bytes`` moved between slots, ``dataset``, ``slots``,
        ``from_dim``, ``to_dim``), ending when every slot has synced."""
        if st.devices != self.slots:          # another transport's slots
            return self._scatter(st.to(self.device), dim, ds.name)
        if st.dim == dim:
            return st
        bounds = (None if dim is None
                  else self._slot_bounds(ds.name, st.shape, dim))
        if st.dim is None:
            return ShardedTensor(
                [_narrow(t, dim, lo, hi - lo).contiguous()
                 for t, (lo, hi) in zip(st.shards, bounds)], dim,
                self.slots)
        span = (_copy_span("transport.alltoall", ds, dataset=ds.name,
                           slots=len(self.slots), from_dim=st.dim,
                           to_dim=dim) if record
                else contextlib.nullcontext({}))
        with span as attrs:
            t0 = time.perf_counter()
            moved = 0
            shards = []
            for j, dev in enumerate(self.slots):
                parts = []
                for i, src in enumerate(st.shards):
                    blk = src if dim is None else _narrow(
                        src, dim, bounds[j][0], bounds[j][1] - bounds[j][0])
                    if i != j:
                        moved += blk.numel() * blk.element_size()
                    if blk.device != dev:
                        blk = blk.contiguous().to(dev, non_blocking=True)
                    parts.append(blk)
                shards.append(torch.cat(parts, st.dim))
            if record:
                self._sync()
                attrs["bytes"] = moved
                self.alltoalls += 1
                self.alltoall_bytes += moved
                self.alltoall_s += time.perf_counter() - t0
        return ShardedTensor(shards, dim, self.slots)

    def _split(self, ds: DataSet, dim: int | None,
               record: bool = True) -> ShardedTensor:
        b = ds.materialise()
        if isinstance(b, ShardedTensor):
            return self._resplit(b, dim, ds, record)
        return self._scatter(b, dim, ds.name, ds)

    def device_put(self, ds: DataSet, pattern_name: str | None = None,
                   data_axis: str = "data") -> ShardedTensor:
        """Place ``ds`` (host, one device, or slots) onto the slots, split
        by its pattern ``pattern_name`` (the first if None)."""
        pat = (ds.get_pattern(pattern_name) if pattern_name
               else next(iter(ds.patterns.values())))
        ds.backing = self._split(ds, self._split_dim(ds, pat, data_axis))
        return ds.backing

    def _layout(self, plugin: BasePlugin) -> tuple[list, list, bool]:
        """Each input's and output's split dim, and whether the plugin
        runs on every slot's share (all of its datasets split) or once on
        the first slot (all replicated)."""
        da = plugin.driver.data_axis
        ins = [self._split_dim(pd.dataset, pd.pattern, da)
               for pd in plugin.in_data]
        outs = [self._split_dim(pd.dataset, pd.pattern, da)
                for pd in plugin.out_data]
        if ins + outs and None not in ins + outs:
            return ins, outs, True
        return [None] * len(ins), [None] * len(outs), False

    def _device_in(self, plugin: BasePlugin,
                   dims: Sequence[int | None] | None = None
                   ) -> list[ShardedTensor]:
        if dims is None:
            dims = self._layout(plugin)[0]
        arrays = []
        for pd, dim in zip(plugin.in_data, dims):
            st = self._split(pd.dataset, dim)
            if not pd.last_use:
                pd.dataset.backing = st    # later consumers reuse the split
            arrays.append(st)
        return arrays

    def _slot_consts(self, plugin: BasePlugin
                     ) -> dict[torch.device, dict[str, Any]]:
        """The plugin's constants replicated to every slot's device."""
        return {dev: _device_consts(plugin, dev)
                for dev in dict.fromkeys(self.slots)}

    def _out_shapes(self, plugin: BasePlugin, layout: tuple
                    ) -> list[list[tuple[int, ...]]]:
        """Each slot's share of each output of a sharded step, after
        checking that the plugin's ``n_frames`` divides each slot's
        frames."""
        dims_in, dims_out, _ = layout
        m = plugin.in_data[0].n_frames if plugin.in_data else 1
        slots = range(len(self.slots))
        if m > 1:
            pd = plugin.in_data[0]
            for j in slots:
                nf = pd.pattern.n_frames(self._local(
                    pd.dataset.name, pd.dataset.shape, dims_in[0], j))
                if nf % m:
                    raise ValueError(
                        f"sharded transport requires n_frames({m}) | each "
                        f"slot's frames({nf}) for plugin {plugin.name}")
        return [[self._local(pd.dataset.name, pd.dataset.shape, d, j)
                 for pd, d in zip(plugin.out_data, dims_out)]
                for j in slots]

    def _run_step(self, plugin: BasePlugin, step, consts: dict,
                  arrays: Sequence[ShardedTensor], layout: tuple
                  ) -> list[ShardedTensor]:
        """``step`` on every slot's share, or once on the first slot."""
        _, dims_out, sharded = layout
        if not sharded:
            with _on(self.device):
                outs = step(consts[self.device],
                            *[a.shards[0] for a in arrays])
            return [self._replicate(o) for o in outs]
        shapes = self._out_shapes(plugin, layout)
        per_slot = []
        for j, dev in enumerate(self.slots):
            with _on(dev):
                per_slot.append(step(consts[dev],
                                     *[a.shards[j] for a in arrays],
                                     shapes=shapes[j]))
        return [ShardedTensor([o[k] for o in per_slot], d, self.slots)
                for k, d in enumerate(dims_out)]

    def run_plugin(self, plugin: BasePlugin) -> list[Any]:
        self._check_driver(plugin)
        layout = self._layout(plugin)
        arrays = self._device_in(plugin, layout[0])
        consts = self._slot_consts(plugin)
        step = self.compile_cache.get_or_build(
            self._plugin_key(plugin, consts[self.device]),
            lambda: self._plugin_fn(plugin))
        outs = self._run_step(plugin, step, consts, arrays, layout)
        del arrays
        for pd, o in zip(plugin.out_data, outs):
            pd.dataset.backing = o
        self._release(plugin)
        self._sync()
        return outs

    def run_plugin_batch(self, plugins: Sequence[BasePlugin]) -> None:
        """Gang execution on the slots: on each slot the members' shares
        fold into one frame axis, so each kernel launches once per slot
        for the whole gang.  Raises :class:`GangSignatureMismatch` where
        :meth:`CudaTransport.run_plugin_batch` does."""
        all_consts = [self._slot_consts(p) for p in plugins]
        k0 = self._gang_check(plugins, [c[self.device] for c in all_consts])
        for p in plugins:
            self._check_driver(p)
        step = self.compile_cache.get_or_build(
            ("batch", k0), lambda: self._batch_fn(plugins[0]))
        layout = self._layout(plugins[0])
        dims_in, dims_out, sharded = layout
        members = [self._device_in(p, dims_in) for p in plugins]
        shapes = self._out_shapes(plugins[0], layout) if sharded else None
        per_slot = []
        for j, dev in enumerate(self.slots if sharded else self.slots[:1]):
            with _on(dev):
                per_slot.append(step([c[dev] for c in all_consts],
                                     [[a.shards[j] for a in m]
                                      for m in members],
                                     shapes=shapes and shapes[j]))
        del members
        for jm, p in enumerate(plugins):
            for k, (pd, d) in enumerate(zip(p.out_data, dims_out)):
                pd.dataset.backing = (
                    ShardedTensor([o[jm][k] for o in per_slot], d,
                                  self.slots) if sharded
                    else self._replicate(per_slot[0][jm][k]))
            self._release(p)
        self._sync()

    def _measured_inputs(self, plugins: Sequence[BasePlugin]) -> tuple:
        """The first slot's share of each input and output: the cost is
        one slot's step, as the reference's cost analysis of an SPMD
        program is per device."""
        layout = self._layout(plugins[0])
        shapes = (self._out_shapes(plugins[0], layout)[0] if layout[2]
                  else None)
        return [[self._split(pd.dataset, d, record=False).shards[0]
                 for pd, d in zip(p.in_data, layout[0])]
                for p in plugins], shapes

    def stats(self) -> dict[str, Any]:
        return {**super().stats(),
                "slots": [str(d) for d in self.slots],
                "alltoalls": self.alltoalls,
                "alltoall_bytes": self.alltoall_bytes,
                "alltoall_s": self.alltoall_s}


# ======================================================================
@dataclasses.dataclass
class IOStats:
    chunk_reads: int = 0          # cache-missing chunk fetches
    chunk_writes: int = 0
    cache_hits: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    wall: float = 0.0

    def merge(self, o: "IOStats") -> "IOStats":
        return IOStats(self.chunk_reads + o.chunk_reads,
                       self.chunk_writes + o.chunk_writes,
                       self.cache_hits + o.cache_hits,
                       self.bytes_read + o.bytes_read,
                       self.bytes_written + o.bytes_written,
                       self.wall + o.wall)


class ChunkedFile:
    """A chunk-addressed on-disk array: np.memmap standing in for a
    parallel-HDF5 dataset.  Chunks are stored contiguously in row-major
    chunk-grid order; an LRU cache of ``cache_bytes`` emulates the HDF5
    raw-chunk cache, and all traffic is counted in :class:`IOStats`."""

    def __init__(self, path: str, shape: Sequence[int], dtype,
                 chunks: Sequence[int],
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 mode: str = "w+"):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(int(min(c, s))
                            for c, s in zip(chunks, self.shape))
        self.grid = tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))
        self.chunk_items = int(np.prod(self.chunks))
        self.chunk_nbytes = self.chunk_items * self.dtype.itemsize
        self._n_items = int(np.prod(self.grid)) * self.chunk_items
        self._readonly = mode == "r"
        self._mm = np.memmap(path, dtype=self.dtype, mode=mode,
                             shape=(self._n_items,))
        self.stats = IOStats()
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_slots = max(1, cache_bytes // max(1, self.chunk_nbytes))
        #: flat chunk ids whose contents changed since last mark_clean()
        self.dirty: set[int] = set()

    def mark_clean(self) -> None:
        self.dirty = set()

    def _flat(self, cidx: tuple[int, ...]) -> int:
        f = 0
        for i, g in zip(cidx, self.grid):
            f = f * g + i
        return f

    def _get_chunk(self, cidx: tuple[int, ...]) -> np.ndarray:
        f = self._flat(cidx)
        if f in self._cache:
            self.stats.cache_hits += 1
            self._cache.move_to_end(f)
            return self._cache[f]
        t0 = time.perf_counter()
        raw = np.array(self._mm[f * self.chunk_items:
                                (f + 1) * self.chunk_items])
        self.stats.wall += time.perf_counter() - t0
        self.stats.chunk_reads += 1
        self.stats.bytes_read += self.chunk_nbytes
        chunk = raw.reshape(self.chunks)
        self._put_cache(f, chunk)
        return chunk

    def _put_cache(self, f: int, chunk: np.ndarray) -> None:
        self._cache[f] = chunk
        self._cache.move_to_end(f)
        while len(self._cache) > self._cache_slots:
            ef, ec = self._cache.popitem(last=False)
            self._flush_chunk(ef, ec)

    def _flush_chunk(self, f: int, chunk: np.ndarray) -> None:
        if self._readonly:
            return
        t0 = time.perf_counter()
        self._mm[f * self.chunk_items:(f + 1) * self.chunk_items] = \
            chunk.reshape(-1)
        self.stats.wall += time.perf_counter() - t0
        self.stats.chunk_writes += 1
        self.stats.bytes_written += self.chunk_nbytes

    def flush(self) -> None:
        for f, c in list(self._cache.items()):
            self._flush_chunk(f, c)
        self._cache.clear()
        self._mm.flush()

    def _touched(self, region: tuple[slice, ...]):
        ranges = []
        for d, sl in enumerate(region):
            start = sl.start or 0
            stop = self.shape[d] if sl.stop is None else min(sl.stop,
                                                             self.shape[d])
            ranges.append(range(start // self.chunks[d],
                                (stop - 1) // self.chunks[d] + 1))
        return ranges

    def read(self, region: tuple[slice, ...]) -> np.ndarray:
        region = tuple(region)
        starts = [sl.start or 0 for sl in region]
        stops = [self.shape[d] if sl.stop is None else sl.stop
                 for d, sl in enumerate(region)]
        out = np.empty([b - a for a, b in zip(starts, stops)],
                       dtype=self.dtype)
        ranges = self._touched(region)
        for cidx in np.ndindex(*[len(r) for r in ranges]):
            c = tuple(ranges[d][cidx[d]] for d in range(len(cidx)))
            chunk = self._get_chunk(c)
            src, dst = [], []
            for d in range(len(c)):
                c0 = c[d] * self.chunks[d]
                lo = max(starts[d], c0)
                hi = min(stops[d], c0 + self.chunks[d], self.shape[d])
                src.append(slice(lo - c0, hi - c0))
                dst.append(slice(lo - starts[d], hi - starts[d]))
            out[tuple(dst)] = chunk[tuple(src)]
        return out

    def write(self, region: tuple[slice, ...], values: np.ndarray) -> None:
        if self._readonly:
            raise OSError(f"{self.path} is open read-only")
        region = tuple(region)
        starts = [sl.start or 0 for sl in region]
        stops = [self.shape[d] if sl.stop is None else sl.stop
                 for d, sl in enumerate(region)]
        values = np.asarray(values, dtype=self.dtype).reshape(
            [b - a for a, b in zip(starts, stops)])
        ranges = self._touched(region)
        for cidx in np.ndindex(*[len(r) for r in ranges]):
            c = tuple(ranges[d][cidx[d]] for d in range(len(cidx)))
            src, dst = [], []
            full = True
            for d in range(len(c)):
                c0 = c[d] * self.chunks[d]
                lo = max(starts[d], c0)
                hi = min(stops[d], c0 + self.chunks[d], self.shape[d])
                if lo > c0 or hi < min(c0 + self.chunks[d], self.shape[d]):
                    full = False
                dst.append(slice(lo - c0, hi - c0))
                src.append(slice(lo - starts[d], hi - starts[d]))
            f = self._flat(c)
            if full and f not in self._cache:
                # whole-chunk write: no read-modify-write round trip
                chunk = np.zeros(self.chunks, dtype=self.dtype)
                self._put_cache(f, chunk)
            else:
                chunk = self._get_chunk(c)
            chunk[tuple(dst)] = values[tuple(src)]
            self.dirty.add(f)

    def read_all(self) -> np.ndarray:
        return self.read(tuple(slice(0, s) for s in self.shape))

    def write_all(self, values: np.ndarray) -> None:
        self.write(tuple(slice(0, s) for s in self.shape), values)
        self.flush()

    def load_from(self, path: str) -> None:
        """Replace this file's contents with another chunk file of the
        SAME shape/layout via an OS-level file copy."""
        if self._readonly:
            raise OSError(f"{self.path} is open read-only")
        if os.path.getsize(path) < self._n_items * self.dtype.itemsize:
            raise ValueError(f"{path} too small for layout {self.chunks} "
                             f"over {self.shape}")
        self._cache.clear()
        self._mm = None
        shutil.copyfile(path, self.path)
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r+",
                             shape=(self._n_items,))
        self.dirty = set(range(int(np.prod(self.grid))))


class ChunkedFileTransport(Transport):
    """Out-of-core mode: every dataset is a ChunkedFile; chunk layouts
    come from the paper's optimiser given (now, next) patterns; plugins
    see m frames at a time read straight off file, moved to the device
    and back — RAM use is O(frames), never O(dataset) (paper §III.A)."""

    name = "chunked_file"

    def __init__(self, directory: str | None = None,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 optimise: bool = True, frames_hint: int = 8,
                 device: str | torch.device = "cuda"):
        super().__init__(device)
        self.dir = directory or tempfile.mkdtemp(prefix="savu_torch_")
        os.makedirs(self.dir, exist_ok=True)
        self.cache_bytes = cache_bytes
        self.optimise = optimise
        self.frames_hint = frames_hint
        self.files: dict[str, ChunkedFile] = {}
        self._counter = 0

    def _new_path(self, name: str) -> str:
        self._counter += 1
        return os.path.join(self.dir, f"{self._counter:03d}_{name}.dat")

    def chunk_for(self, ds: DataSet, now: Pattern, next_: Pattern | None
                  ) -> tuple[int, ...]:
        if not self.optimise:
            return naive_chunks(ds.shape, np.dtype(ds.dtype).itemsize,
                                self.cache_bytes)
        return optimise_chunks(
            ds.shape, now, next_, itemsize=np.dtype(ds.dtype).itemsize,
            frames=self.frames_hint, cache_bytes=self.cache_bytes)

    def allocate(self, ds: DataSet, now: Pattern, next_: Pattern | None
                 ) -> None:
        chunks = self.chunk_for(ds, now, next_)
        cf = ChunkedFile(self._new_path(ds.name), ds.shape, ds.dtype,
                         chunks, self.cache_bytes)
        self.files[ds.name] = cf
        ds.backing = cf
        ds.metadata["chunks"] = chunks

    def ingest(self, ds: DataSet, now: Pattern,
               next_: Pattern | None = None) -> None:
        """Copy a materialised dataset into a chunked file (loader side)."""
        data = to_numpy(ds.materialise())
        self.allocate(ds, now, next_)
        ds.backing.write_all(data)

    def run_plugin(self, plugin: BasePlugin) -> list[Any]:
        self._check_driver(plugin)
        in_pds = plugin.in_data
        out_pds = plugin.out_data
        m = in_pds[0].n_frames
        in_pats = [pd.pattern for pd in in_pds]
        out_pats = [pd.pattern for pd in out_pds]
        slices_iters = [pd.pattern.frame_slices(pd.dataset.shape, m)
                        for pd in in_pds]
        out_iters = [pd.pattern.frame_slices(pd.dataset.shape, m)
                     for pd in out_pds]
        bound = _with_consts(plugin, _device_consts(plugin, self.device))
        for idx_tuple in zip(*slices_iters):
            blocks = []
            for pd, pat, idx in zip(in_pds, in_pats, idx_tuple):
                backing = pd.dataset.backing
                if isinstance(backing, ChunkedFile):
                    raw = backing.read(idx)
                else:
                    raw = to_numpy(pd.dataset.materialise())[idx]
                frames = pat.to_frames(
                    raw, shape=[s.stop - (s.start or 0)
                                for s in _norm_idx(idx,
                                                   pd.dataset.shape)])
                blocks.append(to_tensor(frames, self.device))
            res = _as_list(bound.process_frames(blocks))
            for pd, pat, r, it in zip(out_pds, out_pats, res, out_iters):
                oidx = _norm_idx(next(it), pd.dataset.shape)
                oshape = [s.stop - s.start for s in oidx]
                val = pat.from_frames(to_numpy(r), oshape)
                pd.dataset.backing.write(oidx, val)
        for pd in out_pds:
            pd.dataset.backing.flush()
        return [pd.dataset.backing for pd in out_pds]

    def read(self, ds: DataSet) -> np.ndarray:
        b = ds.materialise()
        if isinstance(b, ChunkedFile):
            return b.read_all()
        return to_numpy(b)

    def total_stats(self) -> IOStats:
        s = IOStats()
        for cf in self.files.values():
            s = s.merge(cf.stats)
        return s

    def stats(self) -> dict[str, Any]:
        return {"io": dataclasses.asdict(self.total_stats())}

    def close(self) -> None:
        for cf in self.files.values():
            cf.flush()


def _norm_idx(idx: tuple, shape: Sequence[int]) -> tuple[slice, ...]:
    out = []
    for d, s in enumerate(idx):
        if isinstance(s, slice):
            out.append(slice(s.start or 0,
                             shape[d] if s.stop is None else s.stop))
        else:
            out.append(slice(int(s), int(s) + 1))
    return tuple(out)
