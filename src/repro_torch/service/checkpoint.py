"""Pipeline checkpoint/resume — Savu's MPI checkpointing, service-grade.

Savu checkpoints a run by keeping every intermediate parallel-HDF5 file
plus a NeXus file that links them; a killed job restarts at the last
finished plugin.  Here each job gets a directory under the store root
holding

* ``checkpoint.nxs.json`` — the **manifest v2**: chain signature,
  completed plugin steps, the required-live dataset set, and one entry
  per surviving dataset (name, shape, dtype, provenance, patterns, file
  link, chunk layout, per-checkpoint chunk increment),
* one ``<dataset>.ckpt`` per surviving dataset — a chunk-addressed file
  (:class:`~repro_torch.core.transport.ChunkedFile` layout, chunks chosen by
  the paper's §IV.A optimiser) standing in for parallel HDF5.

Incremental behaviour (the paper's O(frames)-not-O(dataset) guarantee):

* a dataset whose backing already IS a :class:`ChunkedFile`
  (``ChunkedFileTransport`` jobs) is checkpointed by flushing its dirty
  chunks and **hard-linking** the backing file into the checkpoint
  directory — no dense round-trip through RAM, and steady-state
  checkpoints write only the dirty-chunk bytes;
* a dense dataset (numpy array or torch tensor, on the host or the
  card) is copied to the host and written as a chunk file once,
  at the step that produced it; later checkpoints that still see the
  same version (same ``produced_by``) reuse the file and write nothing.

``format="npy"`` keeps the v1 dense writer (one ``.npy`` per dataset,
rewritten every checkpoint) for comparison benchmarks, and ``restore``
still reads v1 manifests/files, so old checkpoints stay resumable.

Correctness is liveness-driven: the runner's
:meth:`~repro_torch.core.framework.PluginRunner.required_live_names`
names exactly the datasets a resume needs.  ``save`` refuses to
checkpoint past a required dataset whose backing the transport dropped
(``CudaTransport`` frees an input at its final use by setting its
backing to None; a required dataset without one would make an
unresumable checkpoint), and ``restore`` raises
:class:`CheckpointError` — loudly, not a silent "start over" — when a
required dataset is absent or unreadable.  Manifest writes stay atomic
(tmp + rename) so a kill mid-checkpoint leaves the previous consistent
state; hard-linked chunk files trade that atomicity for zero-copy
checkpoints of write-once datasets.  ``save`` reads a sharded backing
to the host slot block by slot block; ``restore`` puts dense datasets
back on the runner transport's device, split over the slots on a
``ShardedTransport``.

The port's copy of ``repro.service.checkpoint``; its checkpoints use the
same manifest and file formats.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from ..core.chunking import DEFAULT_CACHE_BYTES, naive_chunks, \
    optimise_chunks
from ..core.dataset import DataSet
from ..core.framework import PluginRunner
from ..core.transport import ChunkedFile, ShardedTransport, to_tensor
from .job import chain_signature


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot produce a correct resume."""


def _sig_str(sig: tuple) -> str:
    return json.dumps(sig, sort_keys=True)


class CheckpointStore:
    """Per-job checkpoint directories under one root (module docstring
    has the format; spec in ``docs/checkpoint-format.md``)."""

    def __init__(self, root: str, format: str = "chunked",
                 cache_bytes: int = DEFAULT_CACHE_BYTES):
        """Args:
            root: directory holding one subdirectory per job id
                (created if missing).
            format: ``"chunked"`` (manifest v2, incremental) or
                ``"npy"`` (v1 dense rewrite, for comparison).
            cache_bytes: chunk-cache budget for checkpoint file I/O.

        Raises:
            ValueError: unknown ``format``.
        """
        if format not in ("chunked", "npy"):
            raise ValueError(f"unknown checkpoint format {format!r}")
        self.root = root
        self.format = format
        self.cache_bytes = cache_bytes
        self.last_stats: dict[str, Any] = {}
        os.makedirs(root, exist_ok=True)

    def _dir(self, job_id: str) -> str:
        return os.path.join(self.root, job_id)

    def _manifest_path(self, job_id: str) -> str:
        return os.path.join(self._dir(job_id), "checkpoint.nxs.json")

    # -- layout choice ---------------------------------------------------
    def _layout(self, ds: DataSet) -> tuple[int, ...]:
        itemsize = np.dtype(ds.dtype).itemsize
        if ds.patterns:
            now = next(iter(ds.patterns.values()))
            return optimise_chunks(ds.shape, now, None, itemsize=itemsize,
                                   cache_bytes=self.cache_bytes)
        return naive_chunks(ds.shape, itemsize, self.cache_bytes)

    # ------------------------------------------------------------------
    def save(self, job_id: str, runner: PluginRunner) -> dict[str, Any]:
        """Persist the registry of surviving datasets + completion state
        after a finished plugin step.  Returns per-checkpoint IO stats
        (``bytes_written``, ``files_written``, ``files_linked``,
        ``chunks_written``, ``wall``)."""
        t0 = time.perf_counter()
        d = self._dir(job_id)
        os.makedirs(d, exist_ok=True)
        sig = _sig_str(chain_signature(runner.process_list))
        prev = self.load(job_id)
        prev_entries = {}
        if prev and prev.get("chain") == sig:
            prev_entries = {e["name"]: e for e in prev.get("datasets", [])}
        required = runner.required_live_names(runner.current_step)
        for name in sorted(required):
            ds = runner.datasets.get(name)
            if ds is None or not ds.is_populated:
                # the transport dropped a buffer a resume still needs:
                # liveness was bypassed and the checkpoint would be
                # unresumable — refuse loudly
                raise CheckpointError(
                    f"dataset {name!r} is required to resume job "
                    f"{job_id!r} from step {runner.current_step} but "
                    f"its backing was dropped — the transport must keep "
                    f"an input until its PluginData.last_use")

        entries = []
        st = {"bytes_written": 0, "files_written": 0, "files_linked": 0,
              "files_reused": 0, "chunks_written": 0}
        for name, ds in runner.datasets.items():
            if not ds.is_populated:
                # dropped at its final use: nothing downstream (or in a
                # resume) reads it
                continue
            entry = {
                "name": name, "shape": list(ds.shape),
                "dtype": str(np.dtype(ds.dtype)),
                "axis_labels": list(ds.axis_labels),
                "produced_by": ds.produced_by,
                "patterns": sorted(ds.patterns)}
            if self.format == "npy":
                self._save_npy(d, name, ds, runner, entry, st)
            elif isinstance(ds.backing, ChunkedFile):
                self._save_linked(d, name, ds.backing, entry, st)
            else:
                self._save_dense(d, name, ds, runner, entry,
                                 prev_entries.get(name), st)
            entries.append(entry)

        manifest = {
            "version": 2,
            "job_id": job_id,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "chain": sig,
            "completed_steps": runner.current_step,
            "n_steps": runner.n_steps,
            "step_labels": runner.step_labels(),
            "required": sorted(required),
            "datasets": entries,
        }
        stream = runner.stream_state()
        if stream is not None:
            # streaming job (docs/streaming.md): persist the ingest
            # watermark so a resume re-fetches frames from where this
            # worker stopped.  Window cursors are NOT persisted — the
            # restored runner recomputes the windowed head from the
            # saved prefix (deterministic per-frame kernels).
            manifest["stream"] = stream
        tmp = self._manifest_path(job_id) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=2)
        os.replace(tmp, self._manifest_path(job_id))
        st["wall"] = time.perf_counter() - t0
        self.last_stats = st
        return st

    # -- writers ---------------------------------------------------------
    def _save_npy(self, d: str, name: str, ds: DataSet,
                  runner: PluginRunner, entry: dict, st: dict) -> None:
        """v1 dense path: one .npy per dataset, rewritten every time."""
        arr = np.asarray(runner.transport.read(ds))
        path = os.path.join(d, f"{name}.npy")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.save(fh, arr)
        os.replace(tmp, path)
        entry.update(file=os.path.basename(path), format="npy")
        st["bytes_written"] += arr.nbytes
        st["files_written"] += 1

    def _save_linked(self, d: str, name: str, backing: ChunkedFile,
                     entry: dict, st: dict) -> None:
        """ChunkedFile backing: flush dirty chunks, hard-link the backing
        file — the checkpoint shares the inode, so steady-state cost is
        the dirty-chunk flush, not a dense volume round-trip."""
        path = os.path.join(d, f"{name}.ckpt")
        b0 = backing.stats.bytes_written
        dirty = sorted(backing.dirty)
        backing.flush()
        st["bytes_written"] += backing.stats.bytes_written - b0
        same = os.path.exists(path) and \
            os.path.samefile(backing.path, path)
        if same:
            chunks: Any = dirty           # increment only
            st["files_reused"] += 1
        else:
            try:
                tmp = path + ".tmp"
                if os.path.exists(tmp):
                    os.remove(tmp)
                os.link(backing.path, tmp)
                os.replace(tmp, path)
                st["files_linked"] += 1
            except OSError:               # cross-device: fall back to copy
                tmp = path + ".tmp"       # atomic, like the dense writers
                shutil.copyfile(backing.path, tmp)
                os.replace(tmp, path)
                st["bytes_written"] += os.path.getsize(path)
                st["files_written"] += 1
            chunks = "all"
        backing.mark_clean()
        n_chunks = int(np.prod(backing.grid))
        st["chunks_written"] += (n_chunks if chunks == "all"
                                 else len(chunks))
        entry.update(file=os.path.basename(path), format="chunked",
                     layout=list(backing.chunks), chunks_written=chunks)

    def _save_dense(self, d: str, name: str, ds: DataSet,
                    runner: PluginRunner, entry: dict,
                    prev: dict | None, st: dict) -> None:
        """Dense (numpy/torch) backing: write a chunk-addressed file with a
        §IV.A-optimised layout — once.  Dataset versions are write-once
        (a plugin's out replaces its in), so a later checkpoint that sees
        the same ``produced_by`` reuses the file untouched."""
        path = os.path.join(d, f"{name}.ckpt")
        if (prev is not None and prev.get("format") == "chunked"
                and prev.get("produced_by") == ds.produced_by
                and prev.get("shape") == list(ds.shape)
                and prev.get("dtype") == str(np.dtype(ds.dtype))
                and ds.available_extent is None
                and os.path.exists(path)):
            entry.update(file=prev["file"], format="chunked",
                         layout=list(prev["layout"]), chunks_written=[])
            st["files_reused"] += 1
            return
        arr = np.asarray(runner.transport.read(ds))
        layout = self._layout(ds)
        tmp = path + ".tmp"
        cf = ChunkedFile(tmp, ds.shape, ds.dtype, layout,
                         cache_bytes=self.cache_bytes)
        cf.write_all(arr)
        os.replace(tmp, path)
        entry.update(file=os.path.basename(path), format="chunked",
                     layout=list(cf.chunks), chunks_written="all")
        st["bytes_written"] += arr.nbytes
        st["files_written"] += 1
        st["chunks_written"] += int(np.prod(cf.grid))

    # ------------------------------------------------------------------
    def load(self, job_id: str) -> dict[str, Any] | None:
        """Read a job's manifest as a dict (None if absent/corrupt —
        callers treat both as "no checkpoint")."""
        try:
            with open(self._manifest_path(job_id)) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def restore(self, job_id: str, runner: PluginRunner) -> int:
        """Fast-forward a PREPARED-or-fresh runner to the checkpointed
        step, reloading surviving dataset contents.  Returns the number
        of plugin steps skipped (0 = no usable checkpoint: absent, for a
        different chain, or a different step basis).  Raises
        :class:`CheckpointError` when the checkpoint matches this chain
        but a dataset the resume REQUIRES is missing or unreadable —
        resuming would silently feed garbage to a downstream plugin."""
        man = self.load(job_id)
        if man is None:
            return 0
        runner.prepare()
        if man["chain"] != _sig_str(chain_signature(runner.process_list)):
            return 0                      # different pipeline: start over
        # the step basis must match too: skipping N steps of another
        # step list would skip plugins that never ran
        if (man.get("n_steps") != runner.n_steps
                or man.get("step_labels") != runner.step_labels()):
            return 0
        step = int(man["completed_steps"])
        stream = man.get("stream")
        # a streaming checkpoint at step 0 still carries real state (the
        # ingested frame prefix + watermark) and is worth restoring
        lo = 0 if stream is not None else 1
        if not lo <= step <= runner.n_steps:
            return 0
        entries = {e["name"]: e for e in man["datasets"]}
        required = runner.required_live_names(step)
        missing = sorted(required - set(entries))
        if missing:
            raise CheckpointError(
                f"checkpoint for job {job_id!r} at step {step} is missing "
                f"required dataset(s) {missing}; a resume would read "
                f"garbage — clear the checkpoint to restart from scratch")
        if stream is not None:
            # BEFORE skip_to/entry loading: enabling streaming swaps the
            # loader thunk for zeros, which would clobber loaded data if
            # done after
            runner.enable_streaming(dataset=stream["dataset"],
                                    axis=stream["axis"])
        runner.skip_to(step)
        d = self._dir(job_id)
        for name, ent in entries.items():
            ds = runner.datasets.get(name)
            if ds is None or name not in required:
                # nothing at-or-after `step` reads it — reloading would
                # pull a dead volume through RAM for no consumer
                continue
            try:
                self._load_entry(d, ent, ds, runner.transport.device)
            except (FileNotFoundError, ValueError, OSError) as e:
                raise CheckpointError(
                    f"checkpoint for job {job_id!r}: required dataset "
                    f"{name!r} is unreadable ({e})") from e
            if isinstance(runner.transport, ShardedTransport) \
                    and ds.stream_axis is None:
                # back split over the slots (a growing dataset stays on
                # the first slot, where the windows write it)
                runner.transport.device_put(ds)
        if stream is not None:
            runner.restore_stream_state(stream)
        return step

    def _load_entry(self, d: str, ent: dict, ds: DataSet, device) -> None:
        path = os.path.join(d, ent["file"])
        if ent.get("format", "npy") == "npy":    # v1 compatibility
            self._assign(ds, np.load(path), device)
            return
        shape = tuple(int(s) for s in ent["shape"])
        layout = tuple(int(c) for c in ent["layout"])
        if (isinstance(ds.backing, ChunkedFile)
                and ds.backing.shape == shape
                and ds.backing.chunks == layout
                and ds.backing.dtype == np.dtype(ent["dtype"])):
            ds.backing.load_from(path)    # file-level copy, O(1) RAM
            return
        src = ChunkedFile(path, shape, ent["dtype"], layout,
                          cache_bytes=self.cache_bytes, mode="r")
        self._assign(ds, src.read_all(), device)

    @staticmethod
    def _assign(ds: DataSet, arr: np.ndarray, device) -> None:
        """Restored contents into ``ds``: a chunked file is rewritten,
        a tensor backing of the same shape (a streaming dataset) is
        filled in place, anything else becomes a tensor on ``device``."""
        b = ds.backing
        if hasattr(b, "write_all"):
            b.write_all(arr)
        elif isinstance(b, torch.Tensor) and tuple(b.shape) == arr.shape:
            b.copy_(to_tensor(arr, b.device))
        else:
            ds.backing = to_tensor(arr, device)

    def clear(self, job_id: str) -> None:
        """Delete a job's checkpoint directory (called on successful
        completion; idempotent)."""
        shutil.rmtree(self._dir(job_id), ignore_errors=True)
