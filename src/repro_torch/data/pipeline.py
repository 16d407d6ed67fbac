"""LM data pipeline as Savu loader plugins, on the port's core.

The training data path is expressed in the paper's own vocabulary: a
*loader* plugin creates a lazily-backed token DataSet with a BATCH
pattern (slice dim = sample); the batcher slices frames
of ``global_batch`` samples.  Restart safety comes from determinism:
the stream is a pure function of (seed, step), so resuming from a
checkpointed step replays the identical remaining stream with no
cursor state to persist.
"""
from __future__ import annotations

import numpy as np

from ..core.dataset import DataSet
from ..core.patterns import BATCH
from ..core.plugin import BaseLoader


def token_stream(vocab: int, batch: int, seq: int, *, seed: int,
                 step: int) -> dict[str, np.ndarray]:
    """Deterministic synthetic LM batch for (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:],
                             np.full((batch, 1), -1, np.int32)], axis=1)
    return {"tokens": toks, "labels": labels}


class SyntheticTokenLoader(BaseLoader):
    """Loader plugin: a (samples, seq) token dataset with BATCH pattern."""

    name = "synthetic_token_loader"
    parameters = {"vocab": 1024, "samples": 64, "seq": 128, "seed": 0}

    def load(self) -> list[DataSet]:
        p = self.params
        rng = np.random.default_rng(p["seed"])

        def thunk():
            return rng.integers(0, p["vocab"],
                                (p["samples"], p["seq"])).astype(np.int32)

        ds = DataSet(self.out_dataset_names[0],
                     (p["samples"], p["seq"]), np.int32,
                     ("sample", "token"), backing=thunk)
        ds.add_pattern(BATCH, core=("token",), slice_=("sample",))
        ds.metadata["vocab"] = p["vocab"]
        return [ds]


class TokenBatcher:
    """Iterates BATCH-pattern frames of ``global_batch`` samples from a
    token DataSet — the framework-native epoch loop."""

    def __init__(self, dataset: DataSet, global_batch: int):
        self.ds = dataset
        self.gb = global_batch
        self.pattern = dataset.get_pattern(BATCH)

    def __iter__(self):
        data = np.asarray(self.ds.materialise())
        frames = self.pattern.to_frames(data)
        for start in range(0, frames.shape[0] - self.gb + 1, self.gb):
            toks = frames[start:start + self.gb]
            labels = np.concatenate(
                [toks[:, 1:], np.full((self.gb, 1), -1, np.int32)], axis=1)
            yield {"tokens": toks, "labels": labels}
