"""Process lists + the pre-flight *plugin list check* (paper §III.E).

A process list is an ordered sequence of plugin entries (class + params +
in/out dataset names), starting with >=1 loader and ending with a saver.
``check()`` replays the chain symbolically and breaks the run before
processing on any inconsistency.

State carried across from the JAX package: :meth:`ProcessList.load`
reads the JSON that ``repro``'s ``ProcessList.save`` writes, as plain
data, and maps each plugin path under ``repro.`` to the same path under
``repro_torch.``.  Nothing of ``repro`` is imported.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import json
from typing import Any, Sequence, Type

from .plugin import BaseLoader, BasePlugin, BaseSaver

#: plugin paths saved by the JAX package start with this prefix ...
REFERENCE_PREFIX = "repro."
#: ... and resolve to the same module path under the port
PORT_PREFIX = "repro_torch."


def port_plugin_path(path: str) -> str:
    """``repro.tomo.plugins.X`` -> ``repro_torch.tomo.plugins.X``."""
    if path.startswith(REFERENCE_PREFIX):
        return PORT_PREFIX + path[len(REFERENCE_PREFIX):]
    return path


@dataclasses.dataclass
class PluginEntry:
    cls: Type[BasePlugin]
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    in_datasets: tuple[str, ...] = ()
    out_datasets: tuple[str, ...] = ()

    def instantiate(self) -> BasePlugin:
        return self.cls(in_datasets=list(self.in_datasets),
                        out_datasets=list(self.out_datasets), **self.params)

    def to_json(self) -> dict:
        return {"plugin": f"{self.cls.__module__}.{self.cls.__qualname__}",
                "params": {k: v for k, v in self.params.items()
                           if _is_jsonable(v)},
                "in_datasets": list(self.in_datasets),
                "out_datasets": list(self.out_datasets)}

    @staticmethod
    def from_json(d: dict) -> "PluginEntry":
        mod, _, qual = port_plugin_path(d["plugin"]).rpartition(".")
        cls = getattr(importlib.import_module(mod), qual)
        return PluginEntry(cls, dict(d.get("params", {})),
                           tuple(d.get("in_datasets", ())),
                           tuple(d.get("out_datasets", ())))


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


class ProcessListError(ValueError):
    pass


@dataclasses.dataclass
class ProcessList:
    entries: list[PluginEntry] = dataclasses.field(default_factory=list)

    def add(self, cls: Type[BasePlugin], *, params: dict | None = None,
            in_datasets: Sequence[str] = (), out_datasets: Sequence[str] = ()
            ) -> "ProcessList":
        self.entries.append(PluginEntry(cls, dict(params or {}),
                                        tuple(in_datasets),
                                        tuple(out_datasets)))
        return self

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump([e.to_json() for e in self.entries], fh, indent=2)

    @staticmethod
    def load(path: str) -> "ProcessList":
        """Load a saved process list — the port's own or one the JAX
        package wrote (plugin paths are mapped to the port)."""
        with open(path) as fh:
            return ProcessList([PluginEntry.from_json(d)
                                for d in json.load(fh)])

    def check(self) -> list[str]:
        """Symbolically replay the chain; raise ProcessListError on the
        first structural problem.  Returns the list of dataset names that
        survive to the saver."""
        if not self.entries:
            raise ProcessListError("empty process list")
        loaders = [e for e in self.entries if issubclass(e.cls, BaseLoader)]
        savers = [e for e in self.entries if issubclass(e.cls, BaseSaver)]
        if not loaders:
            raise ProcessListError("process list must start with a loader")
        if not savers:
            raise ProcessListError("process list must end with a saver")
        first_non_loader = next(i for i, e in enumerate(self.entries)
                                if not issubclass(e.cls, BaseLoader))
        if any(issubclass(e.cls, BaseLoader)
               for e in self.entries[first_non_loader:]):
            raise ProcessListError("all loaders must come first")
        if not issubclass(self.entries[-1].cls, BaseSaver):
            raise ProcessListError("the final plugin must be a saver")

        available: set[str] = set()
        for i, e in enumerate(self.entries):
            where = f"entry {i} ({e.cls.__name__})"
            if issubclass(e.cls, BaseLoader):
                dup = set(e.out_datasets) & available
                if dup:
                    raise ProcessListError(
                        f"{where}: dataset names {sorted(dup)} already exist")
                if not e.out_datasets:
                    raise ProcessListError(f"{where}: loader must name its "
                                           "out_datasets")
                available |= set(e.out_datasets)
            elif issubclass(e.cls, BaseSaver):
                missing = set(e.in_datasets) - available
                if missing:
                    raise ProcessListError(
                        f"{where}: saver input {sorted(missing)} not available"
                        f" (have {sorted(available)})")
            else:
                n_in = e.cls.n_in_datasets
                n_out = e.cls.n_out_datasets
                if len(e.in_datasets) != n_in:
                    raise ProcessListError(
                        f"{where}: needs {n_in} in_datasets, got "
                        f"{list(e.in_datasets)}")
                if len(e.out_datasets) != n_out:
                    raise ProcessListError(
                        f"{where}: needs {n_out} out_datasets, got "
                        f"{list(e.out_datasets)}")
                missing = set(e.in_datasets) - available
                if missing:
                    raise ProcessListError(
                        f"{where}: in_datasets {sorted(missing)} not "
                        f"available (have {sorted(available)})")
                # an out_dataset with an existing name REPLACES it (paper
                # §III.B); a new name creates a new dataset
                available |= set(e.out_datasets)
                sig = inspect.signature(e.cls.__init__)
                ctor = {n for n, p in sig.parameters.items()
                        if n not in ("self",) and
                        p.kind not in (inspect.Parameter.VAR_KEYWORD,
                                       inspect.Parameter.VAR_POSITIONAL)}
                valid = set(e.cls.parameters) | ctor
                unknown = set(e.params) - valid
                if unknown:
                    raise ProcessListError(
                        f"{where}: unknown params {sorted(unknown)} "
                        f"(valid: {sorted(valid)})")
        return sorted(available)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)
