"""Plugin base classes + drivers (paper §III.F).

A plugin is an independent processing step.  It declares how many
in/out datasets it needs, sets up its out_datasets (shape, axis labels,
patterns) in ``setup``, and implements ``process_frames``, which maps a
block of input frames (torch tensors with the frames leading) to output
frames.  The framework owns all data movement.

Drivers (paper §III.F.1): Savu's CPU driver lets every process run the
plugin; its GPU driver restricts a plugin to processes that own a GPU.
Here a :class:`DeviceDriver` names the device types a plugin may run
on, and a transport refuses a plugin whose driver excludes its device.
It also names the mesh axes the plugin distributes over, as the JAX
package's ``MeshDriver`` does: on a ``ShardedTransport`` a plugin with a
data axis runs on every slot's share, one without runs once, replicated.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .dataset import DataSet


@dataclasses.dataclass(frozen=True)
class DeviceDriver:
    """The device types (``torch.device.type``) a plugin may run on, and
    the mesh axes it distributes over (the first is its data axis)."""
    devices: tuple[str, ...] = ("cuda", "cpu")
    axes: tuple[str, ...] = ("data",)

    def allows(self, device: torch.device) -> bool:
        return device.type in self.devices

    @property
    def data_axis(self) -> str | None:
        return self.axes[0] if self.axes else None


CPU_DRIVER = DeviceDriver(("cuda", "cpu"))
GPU_DRIVER = DeviceDriver(("cuda",))


@dataclasses.dataclass
class PluginData:
    """Per-plugin view onto a dataset (paper §III.F.4): which access
    pattern and how many frames per processing call."""
    dataset: DataSet
    pattern_name: str = ""
    n_frames: int = 1
    #: True when this plugin step is the dataset's FINAL consumer — the
    #: runner sets it from its liveness analysis in ``begin_step``; a
    #: transport may only drop an input whose view has ``last_use=True``
    #: (a branching chain reads it again otherwise).  Defaults to True
    #: so direct transport use frees eagerly.
    last_use: bool = True

    @property
    def pattern(self):
        return self.dataset.get_pattern(self.pattern_name)


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


class BasePlugin:
    """Base of all plugins.  Subclass one of BaseFilter/BaseRecon/
    BaseLoader/BaseSaver rather than this directly."""

    name: str = "base_plugin"
    n_in_datasets: int = 1
    n_out_datasets: int = 1
    #: pattern for out_datasets when it differs from the input pattern
    #: (e.g. recon: SINOGRAM in, VOLUME_XZ out); None = same as input.
    out_pattern_name: str | None = None
    driver: DeviceDriver = CPU_DRIVER
    #: user-tunable parameters with defaults; overridden per process-list
    parameters: dict[str, Any] = {}
    #: params that select WHICH data is processed (file path, scan seed)
    #: rather than HOW — excluded from the chain signature
    data_params: tuple[str, ...] = ()
    #: tunable params (filter cutoff, Paganin tau...): their effect on
    #: ``process_frames`` flows ONLY through :meth:`jit_constants`, so
    #: they are excluded from the step's cache signature
    tunable_params: tuple[str, ...] = ()
    #: instance attrs that stay static even though they are arrays or
    #: floats — excluded from jit_constants, folded into the cache key
    static_attrs: tuple[str, ...] = ()

    def __init__(self, **params):
        self.params = {**self.__class__.parameters}
        unknown = set(params) - set(self.params) - {"in_datasets",
                                                    "out_datasets"}
        if unknown:
            raise ValueError(
                f"plugin {self.name!r}: unknown parameters {sorted(unknown)} "
                f"(valid: {sorted(self.params)})")
        self.params.update({k: v for k, v in params.items()
                            if k not in ("in_datasets", "out_datasets")})
        self.in_dataset_names: list[str] = list(params.get("in_datasets", []))
        self.out_dataset_names: list[str] = list(params.get("out_datasets", []))
        self.in_data: list[PluginData] = []
        self.out_data: list[PluginData] = []

    # -- mandatory interface ------------------------------------------
    def setup(self, in_datasets: list[DataSet]) -> list[DataSet]:
        """Describe out_datasets given in_datasets, and set the pattern +
        n_frames on every PluginData.  Default: single in -> single out of
        identical shape, same patterns, first pattern, 1 frame."""
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0])
        pat = self.default_pattern(din)
        self.chunk_frames(pat)
        return [dout]

    def process_frames(self, frames: Sequence[Any]) -> Any:
        """List of per-in-dataset frame blocks (tensors, frames leading)
        -> per-out blocks.  With ``n_frames == 1`` a transport may pass
        the whole frame stack in one call, so the block's leading size
        is any number of frames."""
        raise NotImplementedError

    #: optional gang hook, ``(frames, consts_per_member, counts) ->
    #: out blocks``: the frames of several jobs one after another
    #: (member j owns ``counts[j]`` of them) with each member's own
    #: :meth:`jit_constants`, for a per-frame plugin whose constants
    #: differ between the members (``CudaTransport.run_plugin_batch``).
    #: None: such a gang runs the step once per member.
    process_frames_batched = None

    def frame_bytes(self, frame_shapes: Sequence[tuple[int, ...]]) -> int:
        """Device bytes that :meth:`process_frames` holds at once for
        each frame of its block, beyond the block's inputs and outputs
        (``frame_shapes``: one frame's shape per input).  A transport
        that runs a whole frame stack in one call cuts it into blocks of
        frames whose working set fits the device.  0 (the default):
        undeclared, the stack runs in one call."""
        return 0

    def span_attrs(self) -> dict[str, Any]:
        """Attributes of this plugin's step that its ``process`` span
        carries, from the shapes and parameters ``setup`` fixed (the
        step's cost and launches, where measured, carry their own).
        Empty by default."""
        return {}

    # -- optional hooks -------------------------------------------------
    def pre_process(self) -> None:  # once, before the frame loop
        pass

    def post_process(self) -> None:  # once, after an implicit barrier
        pass

    # -- helpers ---------------------------------------------------------
    def default_pattern(self, din: DataSet) -> str:
        if not din.patterns:
            raise ValueError(f"dataset {din.name!r} has no patterns")
        return next(iter(din.patterns))

    def chunk_frames(self, pattern_name: str, n_frames: int = 1) -> None:
        """Set pattern/nframes on all attached PluginData (in then out)."""
        for pd in self.in_data + self.out_data:
            pd.pattern_name = pattern_name
            pd.n_frames = n_frames

    @classmethod
    def param_spec(cls) -> dict[str, Any]:
        """Introspect this plugin class for the wire format
        (``service.wire``): declared parameters with their defaults,
        which of them are ``data_params`` or sweepable
        (``tunable_params``), and the dataset arity.  Everything
        returned is JSON-serialisable (non-JSON defaults are shown as
        their ``repr``)."""
        params = {}
        for k, v in cls.parameters.items():
            params[k] = {"default": v if _is_jsonable(v) else repr(v),
                         "data_param": k in cls.data_params,
                         "sweepable": k in cls.tunable_params}
        doc = (cls.__doc__ or "").strip().splitlines()
        return {"name": cls.name,
                "doc": doc[0] if doc else "",
                "n_in_datasets": cls.n_in_datasets,
                "n_out_datasets": cls.n_out_datasets,
                "params": params}

    # -- step-cache support ----------------------------------------------
    #: instance attrs that never feed process_frames
    _NON_CONST_ATTRS = frozenset({
        "params", "in_dataset_names", "out_dataset_names",
        "in_data", "out_data"})

    def jit_constants(self) -> dict[str, Any]:
        """Setup-derived values that ``process_frames`` reads off ``self``
        and that VARY with the input data (dark/flat fields, filter
        banks, angles, scalar calibrations...).  A transport hands them
        to the step moved to its device, so one built step serves every
        plugin instance with the same :meth:`cache_signature`.

        Default: every instance attribute that is a tensor, a numpy
        array or a python float.  ints/strs/bools stay static (they
        select shapes/branches) and are folded into
        :meth:`cache_signature` instead."""
        consts: dict[str, Any] = {}
        for k, v in vars(self).items():
            if k in self._NON_CONST_ATTRS or k in self.static_attrs:
                continue
            if _is_array(v):
                consts[k] = v
            elif isinstance(v, float) and not isinstance(v, bool):
                consts[k] = v
        return consts

    def cache_signature(self) -> tuple:
        """Hashable static identity of this plugin for the step cache:
        class + jsonable params + static (int/str/bool/None) attrs.
        ``data_params`` and ``tunable_params`` are excluded: their
        effect flows only through :meth:`jit_constants`."""
        sig_params: dict[str, Any] = {}
        unsignable: list[tuple] = []
        for k, v in sorted(self.params.items()):
            if k in self.data_params or k in self.tunable_params:
                continue
            if _is_jsonable(v):
                sig_params[k] = v
            else:
                # a param we cannot fingerprint: pin the entry to THIS
                # instance's value rather than share a step across
                # different behaviours
                unsignable.append((k, type(v).__qualname__, id(v)))
        params_j = json.dumps(sig_params, sort_keys=True)
        statics = tuple(
            (k, repr(v))
            for k, v in sorted(vars(self).items())
            if k not in self._NON_CONST_ATTRS
            and (isinstance(v, (bool, int, str, type(None)))
                 or k in self.static_attrs
                 or (isinstance(v, (list, tuple, dict))
                     and _is_jsonable(v))))
        return (f"{type(self).__module__}.{type(self).__qualname__}",
                params_j, tuple(unsignable), statics)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


class BaseFilter(BasePlugin):
    """1-in 1-out, same shape — the common filter plugin type."""
    name = "base_filter"
    pattern_name: str | None = None   # subclass fixes its space
    frames: int = 1

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0])
        pat = self.pattern_name or self.default_pattern(din)
        self.chunk_frames(pat, self.frames)
        return [dout]


class BaseRecon(BasePlugin):
    """Sinogram-in, volume-slice-out reconstruction plugins."""
    name = "base_recon"


class BaseLoader(BasePlugin):
    """Creates DataSets lazily (paper: loader loads *information*, not
    data).  ``load`` returns fully-described datasets whose backing may be
    a thunk."""
    name = "base_loader"
    n_in_datasets = 0

    def setup(self, in_datasets):  # loaders use load() instead
        raise RuntimeError("loaders use .load()")

    def load(self) -> list[DataSet]:
        raise NotImplementedError

    def process_frames(self, frames):
        raise RuntimeError("loaders do not process frames")


class BaseSaver(BasePlugin):
    """Persists datasets; called after loaders, retains a link with the
    framework until the chain completes (paper §III.F.2)."""
    name = "base_saver"
    n_out_datasets = 0

    def setup(self, in_datasets):
        self.chunk_frames(self.default_pattern(in_datasets[0]))
        return []

    def save(self, dataset: DataSet) -> None:
        raise NotImplementedError

    def process_frames(self, frames):
        raise RuntimeError("savers do not process frames")


class LambdaFilter(BaseFilter):
    """Quick functional filter: wraps fn(block)->block (testing/examples)."""
    name = "lambda_filter"

    def __init__(self, fn: Callable, pattern: str | None = None,
                 frames: int = 1, out_dtype=None, **params):
        super().__init__(**params)
        self._fn = fn
        self.pattern_name = pattern
        self.frames = frames
        self._out_dtype = out_dtype

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0],
                        dtype=self._out_dtype or din.dtype)
        pat = self.pattern_name or self.default_pattern(din)
        self.chunk_frames(pat, self.frames)
        return [dout]

    def process_frames(self, frames):
        return self._fn(frames[0])

    _fn_tokens = iter(range(1, 1 << 62))

    def cache_signature(self):
        # the wrapped callable is invisible to the default signature;
        # pin the cache entry to this exact function object via a token
        # stored ON the function (id() values can be recycled after GC)
        try:
            token = self._fn.__savu_cache_token__
        except AttributeError:
            token = next(LambdaFilter._fn_tokens)
            try:
                self._fn.__savu_cache_token__ = token
            except (AttributeError, TypeError):
                token = ("id", id(self._fn))   # unpinnable callable
        return super().cache_signature() + (
            ("fn", getattr(self._fn, "__qualname__", "?"), token),)
