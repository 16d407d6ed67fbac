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

Without a transport the runner builds ``CudaTransport("cuda")``: the
chain runs on the card, and a host without one raises.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from .dataset import DataSet
from .plugin import BaseLoader, BasePlugin, BaseSaver, PluginData
from .process_list import ProcessList
from .profiler import Profiler
from .transport import CudaTransport, Transport


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
        count as consuming at ``n_steps``) but produced BEFORE ``step``."""
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
        self._finalise(self._savers)

    # ------------------------------------------------------------------
    def _split(self):
        loaders, procs, savers = [], [], []
        for entry in self.process_list:
            plugin = entry.instantiate()
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
