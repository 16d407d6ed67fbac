"""Transports — who moves the data (paper §III.A / §IV).

Three interchangeable backends, selected at runner construction.  Each
computes on one torch device, ``"cuda"`` unless the caller passes
``device="cpu"``:

* :class:`CudaTransport` — the production mode: datasets live on the
  device as tensors, each plugin step is built once per step key, and a
  step receives the whole frame stack at once (every tomo op takes
  leading dims; a hand-written kernel cannot be vmapped one frame at a
  time).  Stands in for the JAX package's ``ShardedTransport``.
* :class:`InMemoryTransport` — the paper's "serial on a PC" mode: host
  numpy storage, a loop over groups of ``n_frames`` frames, each group
  moved to the device and back.
* :class:`ChunkedFileTransport` — the out-of-core mode: every dataset is
  a chunk-addressed file (np.memmap standing in for parallel HDF5) with
  an LRU chunk cache of the paper's 1 MB default; chunk layouts come
  from the §IV.A optimiser.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import tempfile
import time
import weakref
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..device import resolve_device
from ..kernels.tally import tally
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
    """``a`` (tensor or array-like) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_numpy(a) -> np.ndarray:
    """``a`` as a host numpy array (``np.asarray`` refuses CUDA tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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
    """Device mode — datasets stay on the device as tensors; each plugin
    step (or fused group) is built once per :meth:`_plugin_key`, with its
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
        instance with the same key (same chain, new dataset)."""
        in_pats = [pd.pattern for pd in plugin.in_data]
        out_pats = [pd.pattern for pd in plugin.out_data]
        out_shapes = [pd.dataset.shape for pd in plugin.out_data]
        out_dtypes = [torch_dtype(pd.dataset.dtype) for pd in plugin.out_data]
        m = plugin.in_data[0].n_frames if plugin.in_data else 1

        def step(consts, *arrays, shapes=None):
            # ``shapes``: the outputs' shapes when the inputs are a
            # streaming slab rather than the whole datasets
            bound = _with_consts(plugin, consts)
            frames = [p.to_frames(a) for p, a in zip(in_pats, arrays)]
            if m == 1:
                # per-frame plugins take the whole frame stack at once
                res = _as_list(bound.process_frames(frames))
            else:
                nf = frames[0].shape[0]
                groups = [_as_list(bound.process_frames(
                    [f[s:s + m] for f in frames]))
                    for s in range(0, nf, m)]
                res = [torch.cat(parts) for parts in zip(*groups)]
            return tuple(pat.from_frames(r, shp).to(dt)
                         for r, pat, shp, dt in zip(res, out_pats,
                                                    shapes or out_shapes,
                                                    out_dtypes))

        return step

    def _batch_fn(self, plugin: BasePlugin):
        """Gang step ``(all_consts, members) -> per-member outs`` for
        :meth:`run_plugin_batch`: a per-frame plugin (``n_frames == 1``)
        runs ONCE over the members' frames stacked along the frame axis,
        with the shared constants when every member's agree, or through
        the plugin's ``process_frames_batched`` hook, which takes every
        member's constants and frame count, when they differ
        (:meth:`_gang_check` refuses any other gang)."""
        in_pats = [pd.pattern for pd in plugin.in_data]
        out_pats = [pd.pattern for pd in plugin.out_data]
        out_shapes = [pd.dataset.shape for pd in plugin.out_data]
        out_dtypes = [torch_dtype(pd.dataset.dtype) for pd in plugin.out_data]

        def step(all_consts, members):
            frames = [[p.to_frames(a) for p, a in zip(in_pats, arrays)]
                      for arrays in members]
            counts = [f[0].shape[0] for f in frames]
            stacked = [torch.cat(col) for col in zip(*frames)]
            del frames
            if _same_consts(all_consts):
                res = _as_list(_with_consts(
                    plugin, all_consts[0]).process_frames(stacked))
            else:
                res = _as_list(plugin.process_frames_batched(
                    stacked, all_consts, counts))
            del stacked
            per_out = [torch.split(r, counts) for r in res]
            return [tuple(pat.from_frames(parts[j], shp).to(dt)
                          for parts, pat, shp, dt in zip(
                              per_out, out_pats, out_shapes, out_dtypes))
                    for j in range(len(members))]

        return step

    def _plugin_key(self, plugin: BasePlugin,
                    consts: dict | None = None) -> tuple:
        """Step-cache key: plugin static identity, in/out dataset specs,
        consts structure, driver and device."""
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
                cmeta, plugin.driver.devices, str(self.device))

    def _device_in(self, plugin: BasePlugin) -> list[torch.Tensor]:
        arrays = []
        for pd in plugin.in_data:
            t = to_tensor(pd.dataset.materialise(), self.device)
            if not pd.last_use:
                pd.dataset.backing = t     # later consumers reuse the copy
            arrays.append(t)
        return arrays

    def _release(self, plugin: BasePlugin, produced: Sequence[BasePlugin]
                 ) -> None:
        """Drop device inputs at their final use (the donation rule)."""
        outs = {id(pd.dataset) for p in produced for pd in p.out_data}
        for pd in plugin.in_data:
            if pd.last_use and id(pd.dataset) not in outs \
                    and isinstance(pd.dataset.backing, torch.Tensor):
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
        self._release(plugin, [plugin])
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
        outs = list(step(consts, *[to_tensor(s, self.device) for s in slabs],
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
            self._release(p, [p])
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
            if len(plugins) == 1:
                p = plugins[0]
                step = self.compile_cache.get_or_build(
                    self._plugin_key(p, all_consts[0]),
                    lambda: self._plugin_fn(p))
                outs = step(all_consts[0], *self._device_in(p))
            else:
                step = self.compile_cache.get_or_build(
                    ("batch", self._plugin_key(plugins[0], all_consts[0])),
                    lambda: self._batch_fn(plugins[0]))
                outs = step(all_consts,
                            [self._device_in(p) for p in plugins])
            del outs
        self._sync()
        return {"flops": t.flops + float(fc.get_total_flops()),
                "bytes": t.bytes, "bytes_accessed": t.bytes,
                "peak_memory": float(mem.peak)}

    def run_fused(self, plugins: Sequence[BasePlugin]) -> list[Any]:
        """Run a linear run of plugins as one step: intermediates stay
        on the device and are never stored on their datasets."""
        for p in plugins:
            self._check_driver(p)
        first, last = plugins[0], plugins[-1]
        arrays = self._device_in(first)
        all_consts = [_device_consts(p, self.device) for p in plugins]
        key = ("fused", tuple(self._plugin_key(p, c)
                              for p, c in zip(plugins, all_consts)))

        def builder():
            fns = [self._plugin_fn(p) for p in plugins]

            def chain(all_consts, *arrays):
                cur = arrays
                for f, consts in zip(fns, all_consts):
                    cur = f(consts, *cur)
                return cur

            return chain

        outs = list(self.compile_cache.get_or_build(key, builder)(
            all_consts, *arrays))
        del arrays
        for pd, o in zip(last.out_data, outs):
            pd.dataset.backing = o
        self._release(first, plugins)
        self._sync()
        return outs

    def stats(self) -> dict[str, Any]:
        return {"compile_cache": self.compile_cache.stats()}


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
