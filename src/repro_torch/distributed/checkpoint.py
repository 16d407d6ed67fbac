"""Training checkpoints: save / restore with an async writer, atomic
publish and retention.

Layout per step (the reference's):  <dir>/step_<N>/
    manifest.json            leaf paths, shapes, dtypes, step, extras
    leaf_<i>.npy             one file per leaf

A tree is nested dicts (keys in sorted order), lists and tuples of
tensors, and modules (their ``named_parameters``); the manifest's
``treedef`` lists each leaf's path, such as ``params/layers.0.attn.wq``
or ``opt/m/embed``.  numpy has no bfloat16, so a bf16 leaf is written
through a ``uint16`` view and its dtype recorded beside it.

``save`` takes host copies of every leaf (the one device->host transfer
the train loop waits for); the files are written on a worker thread
unless ``blocking``, into ``.tmp_step_<N>`` renamed to ``step_<N>`` when
complete, so a reader never sees a partial step.  ``restore`` places
each leaf on the template leaf's device (or ``device``) in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from ..models.sharding import distribute


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}/{name}" if path else name, p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}/{i}" if path else str(i))
    else:
        raise TypeError(f"checkpoint leaf {path!r}: {type(tree).__name__} "
                        f"is not a tensor, module, dict, list or tuple")


def _rebuild(tree: Any, it: Iterator[torch.Tensor]) -> Any:
    """``tree`` with its leaves taken from ``it`` in :func:`_leaves`'
    order; a module's parameters are refilled in place."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in list(tree.named_parameters()):
                x = next(it)
                if type(x) is type(p.data):
                    p.data = x
                else:               # a DTensor in place of a tensor
                    owner, _, leaf = name.rpartition(".")
                    mod = tree.get_submodule(owner) if owner else tree
                    setattr(mod, leaf, nn.Parameter(
                        x, requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return type(tree)(_rebuild(x, it) for x in tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == str(torch.bfloat16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``.  Device->host happens here;
        file IO happens on a worker thread unless blocking."""
        self.wait()
        paths, host = [], []
        for path, t in _leaves(tree):
            paths.append(path)
            # a copy even on the CPU: the caller goes on updating in place
            host.append(t.detach().to("cpu", copy=True))
        manifest = {
            "step": int(step),
            "treedef": paths,
            "n_leaves": len(host),
            "shapes": [list(x.shape) for x in host],
            "dtypes": [str(x.dtype) for x in host],
            "extra": extra or {},
            "time": time.time(),
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            for i, t in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), _to_numpy(t))
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: int | None = None,
                device: str | torch.device | None = None,
                mesh: Any = None, shardings: dict | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``template``: each leaf on the
        template leaf's device (``device`` when given) in its dtype.  A
        module in the template gets its parameters refilled in place.

        ``shardings`` (leaf path -> DTensor placements, as
        ``param_shardings`` gives them for a module; a dict template's
        paths are its keys joined by ``/``) re-shards elastically onto
        ``mesh``, a ``DeviceMesh``: each leaf it names becomes a DTensor
        holding this rank's slice, on the mesh's device type."""
        if shardings is not None and mesh is None:
            raise ValueError("restore: shardings need the mesh they "
                             "place on")
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as fh:
            manifest = json.load(fh)
        tmpl = list(_leaves(template))
        if manifest["n_leaves"] != len(tmpl):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template "
                f"has {len(tmpl)} — incompatible trees")
        paths = [p for p, _ in tmpl]
        if manifest["treedef"] != paths:
            bad = next(i for i, (a, b) in enumerate(
                zip(manifest["treedef"], paths)) if a != b)
            raise ValueError(f"leaf {bad}: checkpoint has "
                             f"{manifest['treedef'][bad]!r}, template "
                             f"{paths[bad]!r} — incompatible trees")
        out = []
        for i, (path, t) in enumerate(tmpl):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"leaf {i} ({path}): checkpoint shape {arr.shape} != "
                    f"template {tuple(t.shape)}")
            x = _from_numpy(arr, manifest["dtypes"][i])
            if shardings is not None and path in shardings:
                out.append(distribute(x.to(dtype=t.dtype), mesh,
                                      shardings[path]))
                continue
            # a copy: the tensor owns its memory, not numpy's buffer
            out.append(x.to(device if device is not None else t.device,
                            t.dtype, copy=True))
        return _rebuild(template, iter(out)), manifest
