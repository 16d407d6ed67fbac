"""DataSet — the framework's named, pattern-carrying array handle.

Mirrors the paper's ``Data`` object: a name, a shape, a numpy dtype,
axis labels, access patterns, free-form ``metadata`` and a ``backing``:
nothing yet, a lazy loader thunk, a numpy array, a torch tensor (on the
transport's device) or a chunked file (transport.ChunkedFile).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from .patterns import Pattern, pattern_from_labels


@dataclasses.dataclass
class DataSet:
    name: str
    shape: tuple[int, ...]
    dtype: Any
    axis_labels: tuple[str, ...]
    patterns: dict[str, Pattern] = dataclasses.field(default_factory=dict)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: None (unpopulated), np.ndarray / torch.Tensor (materialised), a
    #: zero-arg callable (lazy loader thunk), or a transport handle.
    backing: Any = None
    #: provenance: which plugin produced it ('' for loader-created)
    produced_by: str = ""
    #: streaming (arrival-driven) extent: how many slots along
    #: ``stream_axis`` hold real data.  None means the dataset is
    #: complete-on-open (the batch assumption every transport makes).
    available_extent: int | None = None
    #: axis label the dataset grows along while streaming (None: static)
    stream_axis: str | None = None

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.axis_labels = tuple(self.axis_labels)
        if len(self.axis_labels) != len(self.shape):
            raise ValueError(
                f"dataset {self.name!r}: {len(self.axis_labels)} axis labels "
                f"for {len(self.shape)}-d shape {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize

    def label_index(self, label: str) -> int:
        try:
            return self.axis_labels.index(label)
        except ValueError:
            raise KeyError(
                f"dataset {self.name!r} has no axis {label!r} "
                f"(labels: {self.axis_labels})") from None

    def add_pattern(self, name: str, *, core: Sequence[str],
                    slice_: Sequence[str],
                    shard_axes: Mapping[str, str] | None = None) -> Pattern:
        """Register a pattern by axis *labels* (the paper's add_pattern)."""
        pat = pattern_from_labels(name, self.axis_labels, core, slice_,
                                  shard_axes)
        self.patterns[name] = pat
        return pat

    def get_pattern(self, name: str) -> Pattern:
        if name not in self.patterns:
            raise KeyError(
                f"dataset {self.name!r} has no pattern {name!r} "
                f"(available: {sorted(self.patterns)})")
        return self.patterns[name]

    def materialise(self):
        """Resolve lazy backing to an array (loaders are lazy, paper §III.F.2)."""
        if self.backing is None:
            raise RuntimeError(f"dataset {self.name!r} has no data yet")
        if callable(self.backing) and not hasattr(self.backing, "shape"):
            self.backing = self.backing()
        return self.backing

    @property
    def is_populated(self) -> bool:
        return self.backing is not None

    def like(self, name: str | None = None, *, shape=None, dtype=None,
             axis_labels=None, patterns: bool = True) -> "DataSet":
        """Template a new (empty) dataset from this one — used by plugin
        ``setup`` to describe out_datasets."""
        new = DataSet(
            name=name or self.name,
            shape=tuple(shape) if shape is not None else self.shape,
            dtype=dtype if dtype is not None else self.dtype,
            axis_labels=tuple(axis_labels) if axis_labels is not None
            else self.axis_labels,
            metadata=dict(self.metadata),
        )
        if patterns and new.shape == self.shape:
            new.patterns = dict(self.patterns)
        return new

    def __repr__(self):
        state = "populated" if self.is_populated else "empty"
        return (f"DataSet({self.name!r}, shape={self.shape}, "
                f"dtype={np.dtype(self.dtype).name}, "
                f"patterns={sorted(self.patterns)}, {state})")
