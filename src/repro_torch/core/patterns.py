"""Data access patterns — the heart of the Savu design.

A *pattern* partitions the dimensions of an N-d dataset into

  * ``core`` dims  — delivered whole to a plugin (one "frame"),
  * ``slice`` dims — iterated over; the first slice dim is the
    fastest-changing one.

:meth:`Pattern.to_spec` places a dataset on a data axis: its first slice
dim is split over the axis, explicit ``shard_axes`` (dim index -> axis
name) override that, core dims replicate.  ``ShardedTransport`` splits
datasets over its slots by this rule, and the dry-runs place them on
their fake meshes by it.  :meth:`Pattern.to_frames` /
:meth:`Pattern.from_frames` take numpy arrays and torch tensors alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Mapping, Sequence

import torch

PROJECTION = "PROJECTION"
SINOGRAM = "SINOGRAM"
SPECTRUM = "SPECTRUM"
DIFFRACTION = "DIFFRACTION"
VOLUME_XZ = "VOLUME_XZ"
TIMESERIES = "TIMESERIES"
BATCH = "BATCH"
SEQUENCE = "SEQUENCE"
TOKENS = "TOKENS"
EXPERT = "EXPERT"
HEADS = "HEADS"


def _permute(array, perm: Sequence[int]):
    # torch's ``transpose`` swaps two dims; a full permutation is ``permute``
    if isinstance(array, torch.Tensor):
        return array.permute(*perm)
    return array.transpose(perm)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A named core/slice partition of an ``ndim``-dimensional dataset."""

    name: str
    core_dims: tuple[int, ...]
    slice_dims: tuple[int, ...]
    shard_axes: Mapping[int, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        dims = tuple(self.core_dims) + tuple(self.slice_dims)
        if len(set(dims)) != len(dims):
            raise ValueError(
                f"pattern {self.name!r}: core and slice dims overlap: "
                f"core={self.core_dims} slice={self.slice_dims}")
        if sorted(dims) != list(range(len(dims))):
            raise ValueError(
                f"pattern {self.name!r}: dims must cover 0..ndim-1 exactly, "
                f"got core={self.core_dims} slice={self.slice_dims}")
        for d in self.shard_axes:
            if d not in dims:
                raise ValueError(
                    f"pattern {self.name!r}: shard axis for unknown dim {d}")

    @property
    def ndim(self) -> int:
        return len(self.core_dims) + len(self.slice_dims)

    def dim_type(self, dim: int) -> str:
        """'core' | 'slice' (first slice dim) | 'other' (remaining)."""
        if dim in self.core_dims:
            return "core"
        if self.slice_dims and dim == self.slice_dims[0]:
            return "slice"
        if dim in self.slice_dims:
            return "other"
        raise ValueError(f"dim {dim} not in pattern {self.name!r}")

    def frame_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        self._check_shape(shape)
        return tuple(shape[d] for d in self.core_dims)

    def n_frames(self, shape: Sequence[int]) -> int:
        self._check_shape(shape)
        return math.prod(shape[d] for d in self.slice_dims) if self.slice_dims else 1

    def _check_shape(self, shape: Sequence[int]) -> None:
        if len(shape) != self.ndim:
            raise ValueError(
                f"pattern {self.name!r} is {self.ndim}-d but shape {shape} "
                f"is {len(shape)}-d")

    # Frame-major order: slice dims first (slowest to fastest), then the
    # core dims, so flattening gives frames in the paper's order.
    def frame_major_axes(self) -> tuple[int, ...]:
        slow_to_fast = tuple(reversed(self.slice_dims))
        return slow_to_fast + tuple(self.core_dims)

    def to_frames(self, array, shape: Sequence[int] | None = None):
        """Reshape ``array`` -> (n_frames, *frame_shape)."""
        shape = tuple(array.shape) if shape is None else tuple(shape)
        self._check_shape(shape)
        arr = _permute(array, self.frame_major_axes())
        nf = self.n_frames(shape)
        return arr.reshape((nf,) + self.frame_shape(shape))

    def from_frames(self, frames, shape: Sequence[int]):
        """Inverse of :meth:`to_frames` for an output dataset of ``shape``."""
        shape = tuple(shape)
        self._check_shape(shape)
        perm = self.frame_major_axes()
        arr = frames.reshape(tuple(shape[d] for d in perm))
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        return _permute(arr, inv)

    def frame_slices(self, shape: Sequence[int], m: int = 1
                     ) -> Iterator[tuple[slice, ...]]:
        """Yield index tuples selecting ``m`` frames at a time; frames
        advance fastest along ``slice_dims[0]`` (paper §III.C)."""
        self._check_shape(shape)
        if not self.slice_dims:
            yield tuple(slice(None) for _ in shape)
            return
        first = self.slice_dims[0]
        rest = self.slice_dims[1:]
        rest_sizes = [shape[d] for d in rest]
        for rest_idx in _ndindex(rest_sizes):
            for start in range(0, shape[first], m):
                idx: list = [slice(None)] * len(shape)
                idx[first] = slice(start, min(start + m, shape[first]))
                for d, i in zip(rest, rest_idx):
                    idx[d] = slice(i, i + 1)
                yield tuple(idx)

    def to_spec(self, data_axis: str | None = "data") -> tuple:
        """The spec (one axis name or None per dim) of the canonical
        layout: the first slice dim on ``data_axis``; explicit
        ``shard_axes`` entries override or extend it; core dims
        replicate."""
        spec: list = [None] * self.ndim
        if self.slice_dims and data_axis is not None:
            spec[self.slice_dims[0]] = data_axis
        for d, ax in self.shard_axes.items():
            spec[d] = ax
        return tuple(spec)

    def with_shard_axes(self, shard_axes: Mapping[int, str]) -> "Pattern":
        return dataclasses.replace(self, shard_axes=dict(shard_axes))


def _ndindex(sizes: Sequence[int]) -> Iterator[tuple[int, ...]]:
    if not sizes:
        yield ()
        return
    total = math.prod(sizes)
    for flat in range(total):
        idx = []
        rem = flat
        for s in reversed(sizes):
            idx.append(rem % s)
            rem //= s
        yield tuple(reversed(idx))


def pattern_from_labels(name: str, axis_labels: Sequence[str],
                        core: Sequence[str], slice_: Sequence[str],
                        shard_axes: Mapping[str, str] | None = None) -> Pattern:
    """Build a Pattern from axis labels rather than dim indices."""
    index = {lab: i for i, lab in enumerate(axis_labels)}
    missing = [l for l in tuple(core) + tuple(slice_) if l not in index]
    if missing:
        raise ValueError(f"labels {missing} not in axis_labels {axis_labels}")
    sa = {index[k]: v for k, v in (shard_axes or {}).items()}
    return Pattern(name,
                   tuple(index[l] for l in core),
                   tuple(index[l] for l in slice_),
                   sa)
