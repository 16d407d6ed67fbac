"""What the drivers share: the seed's scan model, pools of bands, the
seeded sample of requests whose output is compared, the program's spans
as :class:`~tomobench.record.Span`, and the comparison of sampled slices
with the reference."""
from __future__ import annotations

import random
import time
from types import SimpleNamespace
from typing import Any, Sequence

import numpy as np
import torch

from . import scans, yardsticks
from .bench import Cell
from .record import Record, Span
from .reference import chain as ref_chain
from .reference.compare import Check, limit_of, slice_rel_err, worst

ERR = "recon_max_rel_err"


def seed_words(seed: int, *words: int) -> int:
    return scans._seed(seed, *words)


def program_spans(trace) -> list[Span]:
    """A program trace's finished spans."""
    return [Span(s.name, s.start, s.end, dict(s.attrs))
            for s in trace.spans() if s.end is not None]


class Sample:
    """A seeded uniform sample of ``k`` of the window's completed
    requests (reservoir sampling: the count is not known beforehand).
    It keeps references to what the program returned, never copies, so
    keeping costs the window nothing."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed_words(seed, 0x5A4D))
        self.seen = 0
        self.kept: list[tuple[int, Any]] = []

    def offer(self, index: int, item: Any) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, item))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (index, item)


class Driver:
    """One cell's run: :meth:`setup` (scans, the system, warm-up),
    :meth:`window` (the measured requests), :meth:`free` (the program's
    state), :meth:`check` (the sample against the reference)."""

    def __init__(self, cell: Cell, prog: SimpleNamespace,
                 device: torch.device, seed: int, seconds: float):
        self.cell, self.prog, self.device = cell, prog, device
        self.seed, self.seconds = int(seed), float(seconds)
        self.config, self.traffic = cell.config, cell.traffic
        self.params = ref_chain.chain_params(self.config["process_list"])
        self.sample = Sample(int(self.traffic["check"]["requests"]), seed)
        self.host_spans: list[Span] = []

    # -- shared pieces -------------------------------------------------
    def model(self, scan: int = 0) -> scans.ScanModel:
        c = self.config
        return scans.ScanModel(self.seed, c["n_det"], c["n_rows"],
                               c["n_angles"], c["scan"], scan)

    def band_pool(self, model: scans.ScanModel, rows: int, n: int
                  ) -> list[dict]:
        """``n`` distinct bands of ``rows`` rows of the scan, aligned to
        ``rows``, drawn by the seed; each a loader's ``scan`` dict with
        ``rows``, the band's row indices in the whole scan."""
        rng = np.random.default_rng(seed_words(self.seed, 0xBA4D, rows))
        starts = rng.choice(model.n_rows // rows, size=n,
                            replace=False) * rows
        proj = model.ellipse_projections(self.device)
        pool = []
        for s in starts:
            b = model.raw(range(int(s), int(s) + rows), self.device, proj)
            if not b["data"].flags.c_contiguous:
                raise RuntimeError("a band's frames are not contiguous")
            b["rows"] = list(range(int(s), int(s) + rows))
            pool.append(b)
        del proj
        return pool

    def span(self, name: str, start: float, end: float, **attrs) -> None:
        self.host_spans.append(Span(name, start, end, attrs))

    def devices(self) -> list[int]:
        """The cards this cell uses (their indices)."""
        if self.device.type != "cuda":
            return []
        return [self.device.index or 0]

    @property
    def out_size(self) -> int:
        return self.params["out_size"] or self.config["n_det"]

    def work(self, slices: int) -> dict:
        """The shapes of a request's steps that the yardsticks count: one
        backprojection of ``slices`` slices, and the raw bytes of their
        correction."""
        c = self.config
        return {"fbp": [{"slices": slices, "angles": c["n_angles"],
                         "n_det": c["n_det"], "out_size": self.out_size}],
                "raw_bytes": yardsticks.correction_raw_bytes(
                    c["n_angles"], slices, c["n_det"])}

    def pick_slices(self, n_rows: int, per: int, salt: int) -> list[int]:
        """``per`` distinct slice indices of a request's ``n_rows``, one
        from each of ``per`` equal parts, drawn by the seed."""
        rng = random.Random(seed_words(self.seed, 0x511CE, salt))
        edges = [n_rows * i // per for i in range(per + 1)]
        return [rng.randrange(lo, hi) for lo, hi in zip(edges, edges[1:])]

    def compare(self, items: list[tuple[np.ndarray, dict, list[int],
                                        float | None]],
                modes: Sequence[str | None] = (None,)
                ) -> dict[str | None, list[Check]]:
        """``items``: (the program's slices (k, N, N), the band's scan,
        the slices' rows in the band, the filter cutoff or None).  Each
        of ``modes`` is a candidate: None the program, a precision the
        control (the reference in that precision standing in for the
        program).  The float32 reference is computed once per item."""
        errs: dict[str | None, list[float]] = {m: [] for m in modes}
        n = 0
        for got, scan, rows, cutoff in items:
            ref = ref_chain.reconstruct(scan, rows, self.params,
                                        self.device, "fp32", cutoff)
            for m in modes:
                cand = got if m is None else ref_chain.reconstruct(
                    scan, rows, self.params, self.device, m, cutoff
                ).cpu().numpy()
                errs[m] += [slice_rel_err(cand[k], ref[k])
                            for k in range(len(rows))]
            n += len(rows)
            del ref
        lim = limit_of(self.cell.limits, ERR)
        return {m: [Check(ERR, worst(e), lim,
                          f"{n} slices of {len(items)} outputs")]
                for m, e in errs.items()}

    # -- the interface -------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def window(self) -> Record:
        raise NotImplementedError

    def free(self) -> None:
        raise NotImplementedError

    def check(self, record: Record, modes: Sequence[str | None] = (None,)
              ) -> dict[str | None, list[Check]]:
        """Each candidate's checks (see :meth:`compare`)."""
        raise NotImplementedError


def now() -> float:
    return time.time()
