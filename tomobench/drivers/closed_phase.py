"""Closed loop, one client: whole scans of a vertical ROI, one after
another, through ``PluginRunner(chain, CudaTransport(card,
compile_cache=shared)).run()`` and ``transport.read(result)``, with
Paganin's phase retrieval in the chain.  The retrieval couples the
rows of a projection, so a request is every row of the ROI.

The traffic mix gives ``scans`` (distinct seeded scans, sent in turn),
``warmup_requests`` and ``check`` (``requests`` sampled from the
window, ``slices_per_request`` compared in each, one from each equal
part of the ROI's rows, so rows beside the padded edges are compared
too).  The comparison is with :mod:`tomobench.reference.paganin`."""
from __future__ import annotations

from .. import scans
from ..harness import ERR
from ..reference import paganin as ref_paganin
from ..reference.compare import Check, limit_of, slice_rel_err, worst
from .closed_runner import ClosedRunner


class ClosedPhase(ClosedRunner):

    def setup(self) -> None:
        # the plugins built from the configuration's parameters first,
        # so that a program which lacks one refuses the cell at once
        for e in self.config["process_list"]:
            self.prog.plugins[e["plugin"]](**e.get("params", {}))
        self.params = ref_paganin.chain_params(self.config["process_list"])
        super().setup()

    def inputs(self) -> list[dict]:
        self.rows = self.config["n_rows"]
        return [scans.whole(self.model(k), self.device)
                for k in range(int(self.traffic["scans"]))]

    def compare(self, items, modes=(None,)):
        """As :meth:`Driver.compare`, against the Paganin chain's
        reference."""
        errs: dict = {m: [] for m in modes}
        n = 0
        for got, scan, rows, cutoff in items:
            ref = ref_paganin.reconstruct(scan, rows, self.params,
                                          self.device, "fp32", cutoff)
            for m in modes:
                cand = got if m is None else ref_paganin.reconstruct(
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


DRIVER = ClosedPhase
