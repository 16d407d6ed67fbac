"""The core framework — runs and controls the processing chain
(paper §III.D, Figs 5–7).

Phases:
  1. **check**  — the plugin-list check (delegated to ProcessList.check),
  2. **setup**  — loaders create lazy datasets; each processing plugin is
     "plugged in": its PluginData views are attached, its ``setup``
     describes the out_datasets, and the transport attaches backing
     storage (Fig 5),
  3. **main**   — per plugin: pre_process → frame loop (via transport) →
     post_process, then the out_dataset *replaces* any in_dataset of the
     same name (Fig 6 (i)),
  4. **finalise** — savers persist surviving datasets; a NeXus-style JSON
     manifest links every intermediate file (paper §III.A).

Fusion (beyond paper): consecutive 1-in/1-out plugins that share a
driver run as one step on the :class:`CudaTransport`, so intermediates
stay on the device.

Streaming (arrival-driven) execution: :meth:`PluginRunner.enable_streaming`
opens the runner against a growing loader dataset that
:meth:`PluginRunner.feed` fills slab by slab; :meth:`PluginRunner.pump`
runs the windowed head of the chain over each new slab on the
transport's device and the barrier plugins once their inputs are
complete; :meth:`PluginRunner.preview` reconstructs the arrived prefix.
The growing datasets live on the transport's device (a chunked file
stays a chunked file), so a slab crosses to the card once.

Without a transport the runner builds ``CudaTransport("cuda")``: the
chain runs on the card, and a host without one raises.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from .dataset import DataSet
from .plugin import BaseLoader, BasePlugin, BaseSaver, PluginData
from .process_list import ProcessList
from .profiler import Profiler
from .transport import (ChunkedFile, CudaTransport, Transport, to_numpy,
                        to_tensor, torch_dtype)


class _StreamState:
    """Arrival-driven execution state for one PluginRunner.

    Tracks the growing root dataset, how far each *windowed* plugin has
    processed along the arrival axis, and which datasets downstream of
    the root also grow (window outputs).  Plugins are classified once at
    :meth:`PluginRunner.enable_streaming`:

    * ``window`` — every streaming input slices along the arrival axis
      with ``n_frames == 1`` and every output carries the axis at full
      size in its slice dims: the plugin runs over each newly arrived
      slab in one call on the transport's device (bit-identical to the
      batch step because each frame is processed independently).
    * ``barrier`` — the arrival axis is a core dim of some input (e.g.
      sinogram-space plugins need all angles), the group is fused, or
      the plugin consumes no streaming data: it runs exactly once, via
      the normal transport path, when all its streaming inputs are
      complete.
    """

    def __init__(self, dataset: DataSet, axis_index: int, axis_label: str):
        self.dataset = dataset
        self.axis_index = axis_index
        self.axis_label = axis_label
        self.total = dataset.shape[axis_index]
        self.ingested = 0
        self.eof = False
        #: (group, plugin_idx) -> "window" | "barrier"
        self.kind: dict[tuple[int, int], str] = {}
        #: (group, plugin_idx) -> frames consumed (window plugins only)
        self.cursors: dict[tuple[int, int], int] = {}
        #: window plugins whose pre_process already ran
        self.begun: set[tuple[int, int]] = set()
        #: id(dataset) -> arrival-axis index, for every streaming dataset
        self.axes: dict[int, int] = {}

    @property
    def complete(self) -> bool:
        return self.ingested >= self.total


class PluginRunner:
    def __init__(self, process_list: ProcessList,
                 transport: Transport | None = None,
                 profiler: Profiler | None = None,
                 fuse: bool = False,
                 output_dir: str | None = None):
        self.process_list = process_list
        self.transport = transport if transport is not None \
            else CudaTransport("cuda")
        self.profiler = profiler or Profiler()
        self.fuse = fuse and isinstance(self.transport, CudaTransport)
        self.output_dir = output_dir
        #: name -> DataSet currently available for processing
        self.datasets: dict[str, DataSet] = {}
        #: every dataset ever produced (for the NeXus-style manifest)
        self.lineage: list[DataSet] = []
        self._prepared = False
        self._groups: list[list[BasePlugin]] = []
        self._step_i = 0
        self._in_step = False
        #: arrival-driven execution state (enable_streaming); None = batch
        self._stream: _StreamState | None = None

    def run(self) -> dict[str, DataSet]:
        self.prepare()
        try:
            while self.step():
                pass
            self.finalise()
        except BaseException:
            # a mid-chain failure must not leak open ChunkedFile handles
            try:
                self.transport.close()
            except Exception:       # noqa: BLE001 — original error wins
                pass
            raise
        return self.datasets

    # -- resumable stepping interface -----------------------------------
    def prepare(self) -> "PluginRunner":
        """Check the process list and run the setup phase; after this the
        runner is a sequence of ``n_steps`` resumable plugin steps."""
        if self._prepared:
            return self
        self.process_list.check()
        self._loaders, self._processors, self._savers = self._split()
        self._setup_phase(self._loaders, self._processors, self._savers)
        self._groups = (self._fusion_groups(self._processors) if self.fuse
                        else [[p] for p in self._processors])
        self._compute_liveness()
        self._step_i = 0
        self._prepared = True
        return self

    @property
    def n_steps(self) -> int:
        return len(self._groups)

    @property
    def current_step(self) -> int:
        return self._step_i

    def step_labels(self) -> list[str]:
        return ["+".join(p.name for p in g) for g in self._groups]

    def result_names(self) -> list[str]:
        """Names of the datasets consumed by savers, in saver order.
        Requires :meth:`prepare`."""
        if not self._prepared:
            raise RuntimeError("result_names before prepare()")
        names: list[str] = []
        for sv in self._savers:
            for n in sv.in_dataset_names:
                if n not in names:
                    names.append(n)
        return names

    # -- dataset liveness ----------------------------------------------
    def _compute_liveness(self) -> None:
        """Per-dataset-object liveness over the step sequence: which step
        produces each dataset version and which step consumes it LAST.
        Savers count as consumers at the sentinel step ``n_steps``."""
        producer: dict[int, int] = {}
        last_use: dict[int, int] = {}
        #: (consume_step, producer_step, dataset name) per use — producer
        #: is -1 for loader-created datasets
        uses: list[tuple[int, int, str]] = []
        for g, group in enumerate(self._groups):
            for p in group:
                for pd in p.in_data:
                    ds = pd.dataset
                    last_use[id(ds)] = g
                    uses.append((g, producer.get(id(ds), -1), ds.name))
                for pd in p.out_data:
                    producer[id(pd.dataset)] = g
        n = len(self._groups)
        for sv in self._savers:
            for name in sv.in_dataset_names:
                ds = self._final.get(name)
                if ds is not None:
                    last_use[id(ds)] = n
                    uses.append((n, producer.get(id(ds), -1), name))
        self._last_use = last_use
        self._uses = uses
        self._producer_of = producer

    def required_live_names(self, step: int) -> set[str]:
        """Dataset names a resume from ``step`` completed steps must get
        back from a checkpoint: consumed at some step >= ``step`` (savers
        count as consuming at ``n_steps``) but produced BEFORE ``step``.

        While a stream is mid-flight the step cursor is pinned at the
        first incomplete group, so this set always holds the growing
        root dataset; windowed plugins ahead of the cursor do not pin
        their partial outputs, because a restore resets their cursors to
        0 and recomputes them from the restored prefix."""
        return {name for g, prod, name in self._uses
                if g >= step and prod < step}

    def begin_step(self) -> list[BasePlugin] | None:
        """Rebind the next group's in_data to the live dataset registry
        and run pre_process.  Returns the group, or None when exhausted.
        The caller executes the group and then calls
        :meth:`complete_step`."""
        if not self._prepared:
            self.prepare()
        if self._in_step:
            raise RuntimeError("begin_step called twice without "
                               "complete_step")
        if self._step_i >= len(self._groups):
            return None
        group = self._groups[self._step_i]
        for p in group:
            for pd in p.in_data:
                if pd.dataset.name in self.datasets:
                    pd.dataset = self.datasets[pd.dataset.name]
                # the step may drop the input only if no later step (or
                # saver) reads this dataset version
                lu = self._last_use.get(id(pd.dataset))
                pd.last_use = lu is not None and lu <= self._step_i
            with self.profiler.timer(p.name, "pre"):
                p.pre_process()
        self._in_step = True
        return group

    def complete_step(self) -> None:
        """Post-process + replacement semantics for the group started by
        :meth:`begin_step`, then advance the step cursor."""
        if not self._in_step:
            raise RuntimeError("complete_step without begin_step")
        for p in self._groups[self._step_i]:
            with self.profiler.timer(p.name, "post"):
                p.post_process()
            self._replace(p)
        self._in_step = False
        self._step_i += 1

    def step(self) -> bool:
        """Run one plugin (or fused group).  Returns False when the chain
        is exhausted."""
        group = self.begin_step()
        if group is None:
            return False
        if len(group) == 1:
            p = group[0]
            with self.profiler.timer(p.name, "process"):
                self.transport.run_plugin(p)
        else:
            label = "+".join(p.name for p in group)
            with self.profiler.timer(label, "process", fused=True):
                self.transport.run_fused(group)
        self.complete_step()
        return True

    def skip_to(self, step: int,
                datasets: dict[str, Any] | None = None) -> None:
        """Resume support: mark the first ``step`` groups as already done
        (replaying their replacement semantics WITHOUT executing them) and
        restore the surviving datasets' contents from ``datasets``
        (name -> host array, e.g. loaded from a checkpoint)."""
        self.prepare()
        if self._step_i != 0:
            raise RuntimeError("skip_to on a runner that already stepped")
        if not 0 <= step <= len(self._groups):
            raise ValueError(f"step {step} outside 0..{len(self._groups)}")
        for group in self._groups[:step]:
            for p in group:
                self._replace(p)
        self._step_i = step
        for name, arr in (datasets or {}).items():
            if name not in self.datasets:
                continue
            ds = self.datasets[name]
            if hasattr(ds.backing, "write_all"):
                ds.backing.write_all(arr)
            else:
                ds.backing = arr

    def finalise(self) -> None:
        if self._step_i < len(self._groups):
            raise RuntimeError(
                f"finalise at step {self._step_i}/{len(self._groups)}")
        if self._stream is not None and not self._stream.complete:
            raise RuntimeError(
                f"finalise mid-stream at frame "
                f"{self._stream.ingested}/{self._stream.total}")
        self._finalise(self._savers)

    # -- streaming (arrival-driven) execution ---------------------------
    @property
    def streaming(self) -> bool:
        return self._stream is not None

    def _require_stream(self) -> _StreamState:
        if self._stream is None:
            raise RuntimeError("streaming not enabled on this runner "
                               "(call enable_streaming first)")
        return self._stream

    def _ensure_writable(self, ds: DataSet) -> None:
        """Swap a lazy loader thunk / unallocated backing for writable
        storage that :meth:`feed` / windows fill in place: a tensor on
        the transport's device.  Chunked files and host arrays already
        take region writes and stay."""
        b = ds.backing
        if b is None or (callable(b) and not hasattr(b, "shape")):
            ds.backing = torch.zeros(ds.shape, dtype=torch_dtype(ds.dtype),
                                     device=self.transport.device)

    @staticmethod
    def _region(ds: DataSet, axis: int, lo: int, hi: int) -> tuple:
        return tuple(slice(lo, hi) if d == axis else slice(0, s)
                     for d, s in enumerate(ds.shape))

    def _read_slab(self, ds: DataSet, axis: int, lo: int, hi: int):
        """Frames [lo, hi) along ``axis``: a view of a tensor backing, a
        host array from a chunked file."""
        b = ds.materialise()
        region = self._region(ds, axis, lo, hi)
        if isinstance(b, ChunkedFile):
            return b.read(region)
        return b[region]

    def _write_slab(self, ds: DataSet, axis: int, lo: int, hi: int,
                    values) -> None:
        b = ds.materialise()
        region = self._region(ds, axis, lo, hi)
        if isinstance(b, ChunkedFile):
            b.write(region, to_numpy(values))
        elif isinstance(b, torch.Tensor):
            b[region] = to_tensor(values, b.device)
        else:
            b[region] = to_numpy(values)

    def enable_streaming(self, dataset: str | None = None,
                         axis: str | None = None) -> "PluginRunner":
        """Open this runner against a *growing* loader dataset: frames
        arrive via :meth:`feed`, :meth:`pump` executes whatever the
        arrived prefix allows, and the chain completes once every frame
        has landed.  ``dataset`` defaults to the sole loader-created
        dataset, ``axis`` to its first axis label (the acquisition
        axis).  Idempotent; must be called before any step runs."""
        self.prepare()
        if self._stream is not None:
            if dataset and self._stream.dataset.name != dataset:
                raise ValueError(
                    f"streaming already enabled on "
                    f"{self._stream.dataset.name!r}, not {dataset!r}")
            return self
        if self._step_i != 0 or self._in_step:
            raise RuntimeError("enable_streaming on a runner that "
                               "already stepped")
        if dataset is None:
            roots = [d for d in self.datasets.values() if not d.produced_by]
            if len(roots) != 1:
                raise ValueError(
                    f"enable_streaming needs an explicit dataset name "
                    f"(loader created {[d.name for d in roots]})")
            ds = roots[0]
        else:
            if dataset not in self.datasets:
                raise KeyError(f"no dataset {dataset!r} to stream into")
            ds = self.datasets[dataset]
        axis = axis or ds.axis_labels[0]
        ai = ds.label_index(axis)
        self._ensure_writable(ds)
        ds.available_extent = 0
        ds.stream_axis = axis
        st = _StreamState(ds, ai, axis)
        st.axes[id(ds)] = ai
        for g, group in enumerate(self._groups):
            for j, p in enumerate(group):
                s_ins = [pd for pd in p.in_data
                         if id(pd.dataset) in st.axes]
                if not s_ins:
                    st.kind[(g, j)] = "barrier"   # no stream dependency
                    continue
                windowed = len(group) == 1 and bool(p.out_data)
                for pd in s_ins:
                    a_in = st.axes[id(pd.dataset)]
                    try:
                        pat = pd.pattern
                    except KeyError:
                        pat = None
                    if pat is None or a_in not in pat.slice_dims \
                            or pd.n_frames != 1:
                        windowed = False
                out_axes = []
                for pd in p.out_data:
                    od = pd.dataset
                    if axis not in od.axis_labels:
                        windowed = False
                        break
                    oi = od.label_index(axis)
                    try:
                        opat = pd.dataset.get_pattern(pd.pattern_name)
                    except KeyError:
                        opat = None
                    if od.shape[oi] != st.total or opat is None \
                            or oi not in opat.slice_dims:
                        windowed = False
                        break
                    out_axes.append((od, oi))
                if windowed:
                    st.kind[(g, j)] = "window"
                    st.cursors[(g, j)] = 0
                    for od, oi in out_axes:
                        self._ensure_writable(od)
                        od.available_extent = 0
                        od.stream_axis = axis
                        st.axes[id(od)] = oi
                else:
                    st.kind[(g, j)] = "barrier"
        self._stream = st
        return self

    def feed(self, frames: Any, start: int) -> int:
        """Append ``frames`` (arrival axis LEADING; a host array or a
        tensor) at frame ``start``, copying them to the dataset's
        storage once.  Frames must arrive contiguously and in order.
        Returns the new watermark."""
        st = self._require_stream()
        ds = st.dataset
        arr = frames if isinstance(frames, torch.Tensor) \
            else np.asarray(frames)
        if arr.ndim != ds.ndim:
            raise ValueError(
                f"feed: frames are {arr.ndim}-d, dataset {ds.name!r} "
                f"is {ds.ndim}-d")
        if st.axis_index != 0:
            arr = (torch.movedim(arr, 0, st.axis_index)
                   if isinstance(arr, torch.Tensor)
                   else np.moveaxis(arr, 0, st.axis_index))
        want = tuple(s for d, s in enumerate(ds.shape)
                     if d != st.axis_index)
        got = tuple(s for d, s in enumerate(arr.shape)
                    if d != st.axis_index)
        if want != got:
            raise ValueError(f"feed: frame shape {got} != dataset "
                             f"frame shape {want}")
        if st.eof:
            raise ValueError("feed after eof")
        if int(start) != st.ingested:
            raise ValueError(f"feed at frame {start}, expected "
                             f"{st.ingested} (out of order)")
        k = arr.shape[st.axis_index]
        if st.ingested + k > st.total:
            raise ValueError(
                f"feed of {k} frames at {start} overruns the dataset "
                f"extent {st.total}")
        arr = (arr.to(torch_dtype(ds.dtype))
               if isinstance(arr, torch.Tensor)
               else arr.astype(ds.dtype, copy=False))
        self._write_slab(ds, st.axis_index, st.ingested, st.ingested + k,
                         arr)
        st.ingested += k
        ds.available_extent = st.ingested
        return st.ingested

    def mark_eof(self) -> None:
        st = self._require_stream()
        if st.ingested != st.total:
            raise ValueError(f"eof at frame {st.ingested}/{st.total} — "
                             f"the stream must cover the dataset extent")
        st.eof = True

    def pump(self) -> int:
        """Execute everything the arrived prefix allows: advance every
        runnable windowed plugin over its new slab (one call on the
        device per slab), then complete groups in order (windows once
        their cursor covers the full extent, barriers via the normal
        transport path once every streaming input is complete).  Steps
        therefore still complete IN ORDER — ``current_step`` keeps
        meaning "count of fully-completed steps" and checkpoints taken
        mid-stream sit at the first incomplete group.  Returns the
        number of executions performed."""
        st = self._require_stream()
        if self._in_step:
            raise RuntimeError("pump during an open step")
        progressed = 0
        moved = True
        while moved:
            moved = False
            # 1) windowed plugins run ahead of the step cursor over
            #    whatever new slab their streaming inputs expose
            for g in range(self._step_i, len(self._groups)):
                for j, p in enumerate(self._groups[g]):
                    if st.kind[(g, j)] != "window":
                        continue
                    static_ready = all(
                        self._producer_of.get(id(pd.dataset), -1)
                        < self._step_i
                        for pd in p.in_data
                        if id(pd.dataset) not in st.axes)
                    if not static_ready:
                        continue
                    lo = st.cursors[(g, j)]
                    hi = min((pd.dataset.available_extent or 0)
                             for pd in p.in_data
                             if id(pd.dataset) in st.axes)
                    if hi <= lo:
                        continue
                    if (g, j) not in st.begun:
                        with self.profiler.timer(p.name, "pre"):
                            p.pre_process()
                        st.begun.add((g, j))
                    with self.profiler.timer(p.name, "process",
                                             window=[lo, hi]):
                        self._run_window(p, lo, hi)
                    st.cursors[(g, j)] = hi
                    for pd in p.out_data:
                        pd.dataset.available_extent = hi
                    moved = True
                    progressed += 1
            # 2) complete groups in order as they become fully done
            while self._step_i < len(self._groups):
                g = self._step_i
                group = self._groups[g]
                if all(st.kind[(g, j)] == "window"
                       for j in range(len(group))):
                    if not all(st.cursors[(g, j)] >= st.total
                               for j in range(len(group))):
                        break
                    for p in group:
                        with self.profiler.timer(p.name, "post"):
                            p.post_process()
                        self._replace(p)
                    self._step_i += 1
                else:
                    ready = all(
                        (pd.dataset.available_extent is None
                         or pd.dataset.available_extent
                         >= pd.dataset.shape[st.axes[id(pd.dataset)]])
                        for p in group for pd in p.in_data
                        if id(pd.dataset) in st.axes)
                    if not ready:
                        break
                    self.step()
                    progressed += 1
                moved = True
        return progressed

    def _run_window(self, p: BasePlugin, lo: int, hi: int) -> None:
        """One windowed plugin over frames [lo, hi) of the arrival axis,
        in one call through the transport (on a :class:`CudaTransport`,
        the step its batch run uses: one kernel launch per slab), with
        the outputs written into the growing datasets."""
        st = self._stream
        slabs = []
        for pd in p.in_data:
            ds = pd.dataset
            if id(ds) in st.axes:
                slabs.append(self._read_slab(ds, st.axes[id(ds)], lo, hi))
            else:
                b = ds.materialise()
                slabs.append(b.read_all() if hasattr(b, "read_all") else b)
        out_shapes = [tuple(hi - lo if d == st.axes[id(pd.dataset)] else s
                            for d, s in enumerate(pd.dataset.shape))
                      for pd in p.out_data]
        outs = self.transport.run_window(p, slabs, out_shapes)
        for pd, vals in zip(p.out_data, outs):
            od = pd.dataset
            self._write_slab(od, st.axes[id(od)], lo, hi, vals)

    def preview(self) -> tuple[np.ndarray, int]:
        """Partial result from the arrived prefix: re-run the chain's
        tail (everything from the first barrier on) over the angle
        prefix that has fully traversed the windowed head, on a
        throwaway :class:`CudaTransport` on the runner transport's
        device with freshly instantiated plugins — the live runner's
        state is read, never written.  Returns ``(array, watermark)``
        where ``watermark`` is the number of arrival-axis frames the
        preview covers (the result itself, covering every frame, once
        the chain has completed).  Raises ValueError while nothing has
        cleared the windowed stages yet."""
        st = self._require_stream()
        res_name = self.result_names()[0]
        if self._step_i >= len(self._groups):
            # the chain has run to its end (and dropped the inputs a
            # re-run would read): the result covers every frame
            return (to_numpy(self.datasets[res_name].materialise()),
                    st.total)
        barrier_g = None
        for g in range(len(self._groups)):
            if any(st.kind[(g, j)] != "window"
                   for j in range(len(self._groups[g]))):
                barrier_g = g
                break
        if barrier_g is None:
            # fully-windowed chain: the final dataset IS the preview
            final = self._final[res_name]
            cut = final.available_extent or 0
            if cut <= 0:
                raise ValueError("no preview available yet")
            return (to_numpy(self._read_slab(final, st.axes[id(final)], 0,
                                             cut)), cut)
        cut = None
        for p in self._groups[barrier_g]:
            for pd in p.in_data:
                if id(pd.dataset) in st.axes:
                    e = pd.dataset.available_extent or 0
                    cut = e if cut is None else min(cut, e)
        if not cut:
            raise ValueError("no preview available yet: no frames have "
                             "cleared the windowed stages")
        tail = [p for g in range(barrier_g, len(self._groups))
                for p in self._groups[g]]
        transport = CudaTransport(self.transport.device)
        new_of: dict[int, DataSet] = {}

        def source(od: DataSet) -> DataSet:
            """A dataset of the preview's own over ``od``'s data (the
            prefix of a streaming one), so nothing the preview's
            transport does to its inputs reaches the live runner."""
            if id(od) not in st.axes:
                b = od.materialise()
                backing = b.read_all() if hasattr(b, "read_all") else b
                shape = od.shape
            else:
                ai = st.axes[id(od)]
                if (od.available_extent or 0) < cut:
                    raise ValueError(
                        f"preview: stream {od.name!r} only at "
                        f"{od.available_extent}/{cut}")
                shape = tuple(cut if d == ai else s
                              for d, s in enumerate(od.shape))
                backing = self._read_slab(od, ai, 0, cut)
            return DataSet(od.name, shape, od.dtype, od.axis_labels,
                           patterns=dict(od.patterns),
                           metadata=dict(od.metadata), backing=backing,
                           produced_by=od.produced_by)

        for orig in tail:
            fresh = self._entry_of[id(orig)].instantiate()
            ins = []
            for pd in orig.in_data:
                nd = new_of.get(id(pd.dataset))
                if nd is None:
                    nd = new_of[id(pd.dataset)] = source(pd.dataset)
                ins.append(nd)
            fresh.in_data = [PluginData(d) for d in ins]
            fresh.out_data = []
            outs = fresh.setup(ins)
            for ds_out, name in zip(outs, fresh.out_dataset_names):
                ds_out.name = name
                fresh.out_data.append(PluginData(ds_out))
            for pd, opd in zip(fresh.out_data, orig.out_data):
                pd.pattern_name = opd.pattern_name
                pd.n_frames = opd.n_frames
                if pd.pattern_name not in pd.dataset.patterns and \
                        pd.pattern_name in ins[0].patterns and \
                        pd.dataset.shape == ins[0].shape:
                    pd.dataset.patterns[pd.pattern_name] = \
                        ins[0].patterns[pd.pattern_name]
                transport.allocate(
                    pd.dataset, pd.dataset.patterns.get(pd.pattern_name),
                    None)
                new_of[id(opd.dataset)] = pd.dataset
            fresh.pre_process()
            transport.run_plugin(fresh)
            fresh.post_process()
        orig_final = self._final[res_name]
        nd = new_of.get(id(orig_final))
        if nd is None:
            raise RuntimeError(f"preview did not produce {res_name!r}")
        return to_numpy(nd.materialise()), cut

    def stream_state(self) -> dict[str, Any] | None:
        """Checkpointable stream snapshot (None when not streaming).
        Window cursors are intentionally NOT persisted: a restore resets
        them and recomputes the windowed head from the restored prefix,
        which keeps the checkpoint to exactly the datasets batch resume
        already captures."""
        if self._stream is None:
            return None
        st = self._stream
        return {"dataset": st.dataset.name, "axis": st.axis_label,
                "ingested": st.ingested, "eof": st.eof,
                "total": st.total}

    def restore_stream_state(self, state: dict[str, Any]) -> None:
        """Re-arm streaming from a checkpoint's ``stream`` block.  Call
        after the checkpointed datasets have been loaded — the ingest
        watermark is restored and the next :meth:`pump` recomputes the
        windowed head over the restored prefix."""
        self.enable_streaming(dataset=state.get("dataset"),
                              axis=state.get("axis"))
        st = self._stream
        st.ingested = int(state.get("ingested", 0))
        st.eof = bool(state.get("eof", False))
        st.dataset.available_extent = st.ingested
        # groups already completed before the checkpoint hold finished
        # (checkpoint-restored) data — mark their windows complete so
        # downstream consumers see the full extent
        for (g, j) in list(st.cursors):
            if g < self._step_i:
                st.cursors[(g, j)] = st.total
                for pd in self._groups[g][j].out_data:
                    pd.dataset.available_extent = st.total

    # ------------------------------------------------------------------
    def _split(self):
        loaders, procs, savers = [], [], []
        #: id(plugin) -> its ProcessList entry, so preview() can
        #: re-instantiate a fresh copy of a tail plugin
        self._entry_of = {}
        for entry in self.process_list:
            plugin = entry.instantiate()
            self._entry_of[id(plugin)] = entry
            if isinstance(plugin, BaseLoader):
                loaders.append(plugin)
            elif isinstance(plugin, BaseSaver):
                savers.append(plugin)
            else:
                procs.append(plugin)
        return loaders, procs, savers

    def _setup_phase(self, loaders, processors, savers):
        # Loaders first (lazy — they create dataset descriptions).
        for ld in loaders:
            with self.profiler.timer(ld.name, "setup"):
                for ds in ld.load():
                    self.datasets[ds.name] = ds
                    self.lineage.append(ds)
        # Processing plugins: attach PluginData, call setup, register outs.
        sym: dict[str, DataSet] = dict(self.datasets)
        for i, p in enumerate(processors):
            ins = [sym[n] for n in p.in_dataset_names]
            p.in_data = [PluginData(d) for d in ins]
            p.out_data = []          # filled after setup describes them
            with self.profiler.timer(p.name, "setup"):
                outs = p.setup(ins)
            if len(outs) != len(p.out_dataset_names):
                raise ValueError(
                    f"plugin {p.name}: setup returned {len(outs)} datasets, "
                    f"process list names {p.out_dataset_names}")
            for ds, name in zip(outs, p.out_dataset_names):
                ds.name = name
                ds.produced_by = f"p{i + 1}.{p.name}"
                p.out_data.append(PluginData(ds))
            # propagate pattern/frames choice made in setup to out views
            for pd in p.out_data:
                pd.pattern_name = (p.out_pattern_name or pd.pattern_name
                                   or p.in_data[0].pattern_name)
                pd.n_frames = p.in_data[0].n_frames
                if pd.pattern_name not in pd.dataset.patterns and \
                        pd.pattern_name in ins[0].patterns and \
                        pd.dataset.shape == ins[0].shape:
                    pd.dataset.patterns[pd.pattern_name] = \
                        ins[0].patterns[pd.pattern_name]
            # transport attaches backing (file/None) using now/next patterns
            nxt = processors[i + 1] if i + 1 < len(processors) else None
            for pd in p.out_data:
                now_pat = pd.dataset.patterns.get(pd.pattern_name)
                next_pat = None
                if nxt is not None and pd.dataset.name in nxt.in_dataset_names:
                    cand = nxt.__class__.__dict__.get("pattern_name")
                    if cand and cand in pd.dataset.patterns:
                        next_pat = pd.dataset.patterns[cand]
                if now_pat is not None:
                    self.transport.allocate(pd.dataset, now_pat, next_pat)
                self.lineage.append(pd.dataset)
            for ds in outs:
                sym[ds.name] = ds
        #: final version of every dataset name (what savers will see)
        self._final = dict(sym)

    def _replace(self, p: BasePlugin):
        """out_dataset replaces in_dataset of the same name (Fig 6 (i))."""
        for pd in p.out_data:
            self.datasets[pd.dataset.name] = pd.dataset

    def _fusion_groups(self, processors):
        """Group consecutive linear 1-in/1-out plugins."""
        groups: list[list[BasePlugin]] = []
        cur: list[BasePlugin] = []
        for p in processors:
            linear = (len(p.in_dataset_names) == 1
                      and len(p.out_dataset_names) == 1
                      and getattr(p, "fusable", True))
            chains = bool(cur) and \
                cur[-1].out_dataset_names[0] == p.in_dataset_names[0] and \
                cur[-1].driver == p.driver
            if linear and (not cur or chains):
                cur.append(p)
            else:
                if cur:
                    groups.append(cur)
                cur = [p] if linear else []
                if not linear:
                    groups.append([p])
        if cur:
            groups.append(cur)
        return groups

    def _finalise(self, savers):
        for sv in savers:
            for name in sv.in_dataset_names:
                if name in self.datasets:
                    with self.profiler.timer(sv.name, "io"):
                        sv.save(self.datasets[name])
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            manifest = {
                "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "datasets": [
                    {"name": d.name, "shape": list(d.shape),
                     "dtype": str(d.dtype), "axis_labels": list(d.axis_labels),
                     "produced_by": d.produced_by,
                     "patterns": sorted(d.patterns),
                     "file": getattr(getattr(d, "backing", None), "path", None)}
                    for d in self.lineage],
            }
            with open(os.path.join(self.output_dir, "savu_manifest.nxs.json"),
                      "w") as fh:
                json.dump(manifest, fh, indent=2)
        self.transport.close()


def run_process_list(process_list: ProcessList,
                     data: dict[str, Any] | None = None,
                     transport: Transport | None = None, **kw
                     ) -> dict[str, DataSet]:
    """One-shot helper: ``data`` pre-populates loader-created datasets
    (name -> host array) before the chain steps, so a process list whose
    loader only *describes* a dataset can be fed inline arrays."""
    runner = PluginRunner(process_list, transport, **kw)
    runner.prepare()
    for name, arr in (data or {}).items():
        ds = runner.datasets.get(name)
        if ds is None or ds.produced_by:
            continue                      # only loader-created datasets
        if hasattr(ds.backing, "write_all"):
            ds.backing.write_all(np.asarray(arr))
        else:
            ds.backing = arr
    while runner.step():
        pass
    runner.finalise()
    return runner.datasets
