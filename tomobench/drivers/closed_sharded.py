"""Closed loop, one client: whole scans, one after another, through
``PluginRunner(chain, ShardedTransport(slots, compile_cache=shared))
.run()`` (the runner's default fusion) and ``transport.read(result)``:
Savu's MPI mode, the chain split over the slots with the change of
pattern between the correction and the sinogram plugins as an
all-to-all.

The configuration's ``transport`` gives ``slots`` (``"all"``: every
visible card, or a count of slots on the run's device) and ``expect``
(the slots a run must find).  The traffic mix gives ``scans`` (distinct
seeded scans, sent in turn), ``warmup_requests`` and ``check``
(``requests`` sampled from the window, ``slices_per_slot`` compared from
each slot's share)."""
from __future__ import annotations

import torch

from .. import scans
from .closed_runner import ClosedRunner


class ClosedSharded(ClosedRunner):

    def inputs(self) -> list[dict]:
        tr = self.config["transport"]
        self.slots = (self.prog.slots_on(self.device.type)
                      if tr["slots"] == "all"
                      else self.prog.slots_on(self.device.type,
                                              int(tr["slots"])))
        if len(self.slots) != int(tr.get("expect", len(self.slots))):
            raise RuntimeError(f"{len(self.slots)} slots, the configuration "
                               f"needs {tr['expect']}")
        self.rows = self.config["n_rows"]
        return [scans.whole(self.model(k), self.device)
                for k in range(int(self.traffic["scans"]))]

    def transport(self):
        return self.prog.ShardedTransport(self.slots,
                                          compile_cache=self.cache)

    def devices(self) -> list[int]:
        return [d.index for d in dict.fromkeys(self.slots)
                if d.type == "cuda"]

    def slices_per_request(self) -> int:
        return int(self.traffic["check"]["slices_per_slot"]) * \
            len(self.slots)


DRIVER = ClosedSharded
