"""Wire format for process lists — JSON specs a remote client can POST.

The paper's facility model ("over 3000 scientific users per year")
implies users who submit process lists to a service they do not run.
That requires a *wire format*: a JSON document that names plugins by
their registered wire name (``BasePlugin.name``) rather than by python
class, carries only JSON-serialisable parameters, and is validated
loudly before anything executes.  Spec v1:

.. code-block:: json

    {"version": 1,
     "plugins": [
       {"plugin": "synthetic_tomo_loader",
        "params": {"n_det": 48, "seed": 3},
        "out_datasets": ["tomo"]},
       {"plugin": "fbp_recon",
        "in_datasets": ["tomo"], "out_datasets": ["recon"]},
       {"plugin": "hdf5_saver", "in_datasets": ["recon"]}]}

``from_spec`` resolves each entry against the plugin registry and
raises :class:`WireError` — naming the offender and the valid
alternatives — on unknown plugins, unknown parameters, or malformed
structure; ``to_spec`` is the exact inverse for registry plugins with
JSON-able params.  Structural chain errors (missing loader/saver,
unwired datasets) are still caught by ``ProcessList.check()``, which
the server runs at submit time.  See ``docs/plugin-spec.md``.

The port's registry is seeded from ``repro_torch.tomo``, whose plugins
carry the JAX package's wire names, so every spec the JAX package's
``to_spec`` writes loads here and gives the same chain.  The port's
loader has one parameter more, ``device`` (where it simulates a scan).
Where a job runs is the service's choice, as the mesh is the JAX
package's, so ``to_spec`` leaves ``device`` out and ``from_spec(spec,
device=...)`` sets it from the service's transport: a spec written here
loads in the JAX package's ``from_spec`` too.
"""
from __future__ import annotations

import inspect
from typing import Any, Iterable, Type

import torch

from ..core.plugin import BasePlugin, _is_jsonable
from ..core.process_list import PluginEntry, ProcessList

WIRE_VERSION = 1
#: spec v2 = v1 plus the top-level ``"streaming": true`` flag (the
#: loader dataset is fed frame-by-frame via POST /jobs/{id}/frames
#: instead of being complete at step 0 — docs/streaming.md)
WIRE_VERSION_STREAMING = 2
#: spec v3 = the ``POST /workflows`` envelope: a DAG of NODES, each
#: node carrying a v1/v2 process-list spec plus ``"after"`` edges and
#: upstream-result references (docs/workflows.md).  Parsed by
#: ``service.workflow`` — individual process-list specs stay
#: v1/v2, which is why v3 is not in ``_ACCEPTED_VERSIONS`` here.
WIRE_VERSION_WORKFLOW = 3
_ACCEPTED_VERSIONS = (WIRE_VERSION, WIRE_VERSION_STREAMING)

#: wire name -> plugin class.  Seeded with the tomography chain below;
#: extend with :func:`register_plugin`.
_REGISTRY: dict[str, Type[BasePlugin]] = {}


class WireError(ValueError):
    """A process-list spec cannot be (de)serialised: unknown plugin,
    unknown/non-JSON parameter, or malformed document structure."""


def register_plugin(cls: Type[BasePlugin], name: str | None = None
                    ) -> Type[BasePlugin]:
    """Add a plugin class to the wire registry (usable as a decorator).

    Args:
        cls: the plugin class to expose over the wire.
        name: wire name; defaults to ``cls.name``.

    Returns:
        ``cls`` unchanged.

    Raises:
        WireError: if the name is already registered to a DIFFERENT
            class — silent re-pointing would change what existing specs
            execute.
    """
    wire_name = name or cls.name
    existing = _REGISTRY.get(wire_name)
    if existing is not None and existing is not cls:
        raise WireError(
            f"wire name {wire_name!r} already registered to "
            f"{existing.__module__}.{existing.__qualname__}")
    _REGISTRY[wire_name] = cls
    return cls


def registered_plugins() -> dict[str, Type[BasePlugin]]:
    """A copy of the wire registry (name -> class)."""
    return dict(_REGISTRY)


def registry_spec() -> dict[str, Any]:
    """JSON-able description of every registered plugin (served at
    ``GET /plugins``): per plugin the declared parameters with defaults,
    ``data_param`` flags, and dataset arity (``BasePlugin.param_spec``)."""
    return {name: cls.param_spec() for name, cls in sorted(_REGISTRY.items())}


# ----------------------------------------------------------------------
def _valid_params(cls: Type[BasePlugin]) -> set[str]:
    """Parameter names a spec may set: the declared ``parameters`` dict
    plus explicit constructor keywords (mirrors ProcessList.check)."""
    sig = inspect.signature(cls.__init__)
    ctor = {n for n, p in sig.parameters.items()
            if n != "self" and p.kind not in (
                inspect.Parameter.VAR_KEYWORD,
                inspect.Parameter.VAR_POSITIONAL)}
    return set(cls.parameters) | (ctor - {"in_datasets", "out_datasets"})


def _str_list(v: Any, where: str, key: str) -> tuple[str, ...]:
    if not isinstance(v, (list, tuple)) or \
            not all(isinstance(s, str) for s in v):
        raise WireError(f"{where}: {key} must be a list of dataset "
                        f"names, got {v!r}")
    return tuple(v)


#: parameters that say where a plugin computes, not what: never written
#: to a spec, set by the service that loads one
LOCAL_PARAMS = ("device",)


def from_spec(spec: dict[str, Any],
              device: str | torch.device | None = None) -> ProcessList:
    """Deserialise a spec v1 document into a :class:`ProcessList`.

    Args:
        spec: parsed JSON document (``{"version": 1, "plugins": [...]}``;
            a bare list of plugin entries is accepted too).
        device: where the chain computes (the service's transport's
            device): set as the ``device`` of every entry whose plugin
            declares one, over any the spec gives.  None keeps the
            spec's, or the plugin's default.

    Returns:
        the reconstructed ProcessList (NOT yet ``check()``-ed — the
        structural chain check is the caller's admission step).

    Raises:
        WireError: malformed document, unknown plugin name (the message
            lists the registered names), unknown parameter for a plugin
            (the message lists the valid ones), or a non-JSON value
            smuggled into ``params``.
    """
    if isinstance(spec, list):
        spec = {"version": WIRE_VERSION, "plugins": spec}
    if not isinstance(spec, dict):
        raise WireError(f"spec must be a JSON object, got "
                        f"{type(spec).__name__}")
    version = spec.get("version", WIRE_VERSION)
    if version not in _ACCEPTED_VERSIONS:
        raise WireError(
            f"unsupported spec version {version!r} (this server speaks "
            f"v{'/v'.join(str(v) for v in _ACCEPTED_VERSIONS)})")
    streaming = bool(spec.get("streaming", False))
    if streaming and version < WIRE_VERSION_STREAMING:
        raise WireError('"streaming": true requires spec version >= '
                        f"{WIRE_VERSION_STREAMING}")
    entries_spec = spec.get("plugins")
    if not isinstance(entries_spec, list) or not entries_spec:
        raise WireError('spec needs a non-empty "plugins" list')

    pl = ProcessList()
    for i, e in enumerate(entries_spec):
        where = f"plugins[{i}]"
        if not isinstance(e, dict) or not isinstance(e.get("plugin"), str):
            raise WireError(f'{where}: each entry must be an object with '
                            f'a "plugin" name, got {e!r}')
        name = e["plugin"]
        cls = _REGISTRY.get(name)
        if cls is None:
            raise WireError(
                f"{where}: unknown plugin {name!r} "
                f"(registered: {sorted(_REGISTRY)})")
        params = e.get("params", {})
        if not isinstance(params, dict):
            raise WireError(f"{where} ({name}): params must be an "
                            f"object, got {params!r}")
        valid = _valid_params(cls)
        unknown = set(params) - valid
        if unknown:
            raise WireError(
                f"{where} ({name}): unknown params {sorted(unknown)} "
                f"(valid: {sorted(valid)})")
        bad = [k for k, v in params.items() if not _is_jsonable(v)]
        if bad:
            raise WireError(f"{where} ({name}): non-JSON param value(s) "
                            f"for {bad}")
        params = dict(params)
        if device is not None and "device" in cls.parameters:
            params["device"] = str(device)
        pl.add(cls, params=params,
               in_datasets=_str_list(e.get("in_datasets", ()), where,
                                     "in_datasets"),
               out_datasets=_str_list(e.get("out_datasets", ()), where,
                                      "out_datasets"))
    if streaming:
        # dynamic attribute: ProcessList stays a plain dataclass and the
        # flag is deliberately NOT part of chain_signature — a streamed
        # chain shares compiled programs and checkpoints with its batch
        # twin (the final outputs are bit-identical)
        pl.streaming = True
    return pl


def to_spec(process_list: ProcessList | Iterable[PluginEntry]
            ) -> dict[str, Any]:
    """Serialise a process list to the spec v1 wire document.

    Args:
        process_list: a ProcessList (or iterable of PluginEntry) whose
            every plugin class is registered and whose params are all
            JSON-able.

    Returns:
        ``{"version": 1, "plugins": [...]}`` — round-trips through
        :func:`from_spec` to an identical chain signature.

    Raises:
        WireError: an entry's class has no wire name (register it), or
            a param value cannot be represented in JSON (e.g. a
            LambdaFilter callable — such chains are in-process only).
    """
    by_cls = {cls: name for name, cls in _REGISTRY.items()}
    out = []
    entries = (process_list.entries
               if isinstance(process_list, ProcessList) else process_list)
    for i, e in enumerate(entries):
        name = by_cls.get(e.cls)
        if name is None:
            raise WireError(
                f"entry {i}: {e.cls.__module__}.{e.cls.__qualname__} is "
                f"not wire-registered — register_plugin() it to serve it")
        bad = [k for k, v in e.params.items()
               if k not in LOCAL_PARAMS and not _is_jsonable(v)]
        if bad:
            raise WireError(f"entry {i} ({name}): param(s) {bad} are not "
                            f"JSON-serialisable")
        entry: dict[str, Any] = {"plugin": name}
        params = {k: v for k, v in e.params.items()
                  if k not in LOCAL_PARAMS}
        if params:
            entry["params"] = params
        if e.in_datasets:
            entry["in_datasets"] = list(e.in_datasets)
        if e.out_datasets:
            entry["out_datasets"] = list(e.out_datasets)
        out.append(entry)
    if getattr(process_list, "streaming", False):
        return {"version": WIRE_VERSION_STREAMING, "streaming": True,
                "plugins": out}
    return {"version": WIRE_VERSION, "plugins": out}


def chain_plugin_names(process_list: ProcessList | Iterable[PluginEntry]
                       ) -> set[str]:
    """Wire names a worker must have registered to execute this chain —
    the broker's plugin-capability filter.  An entry whose class is not
    wire-registered maps to its python qualname, which no worker
    advertises, so such a chain is never leased out."""
    by_cls = {cls: name for name, cls in _REGISTRY.items()}
    entries = (process_list.entries
               if isinstance(process_list, ProcessList) else process_list)
    return {by_cls.get(e.cls, f"{e.cls.__module__}.{e.cls.__qualname__}")
            for e in entries}


# -- default registry: the paper's standard full-field chain ------------
def _register_defaults() -> None:
    from ..tomo import plugins as tomo
    for cls in (tomo.SyntheticTomoLoader, tomo.DarkFlatCorrection,
                tomo.PaganinFilter, tomo.RingRemoval, tomo.SinogramFilter,
                tomo.FBPRecon, tomo.HDF5LikeSaver,
                # workflow building blocks (docs/workflows.md): ingest
                # an upstream node's result, then post-process it
                tomo.UpstreamLoader, tomo.Downsample, tomo.Quantify):
        register_plugin(cls)


_register_defaults()
