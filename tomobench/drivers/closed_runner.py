"""Closed loop, one client: band after band of one scan through
``PluginRunner(chain, CudaTransport(card, compile_cache=shared)).run()``
and ``transport.read(result)``.

The traffic mix gives ``rows_per_request`` (a band's rows),
``pool_bands`` (distinct bands of the seed's scan, drawn by the seed,
sent in order and round again), ``warmup_requests`` and ``check``
(``requests`` sampled from the window, ``slices_per_request`` compared
in each).  A request is due when the client sends it; the window ends
at the last completion."""
from __future__ import annotations

import torch

from .. import program
from ..harness import Driver, now, program_spans
from ..record import Record, Request

#: the transport counters a request keeps (a ShardedTransport's)
STATS = ("alltoalls", "alltoall_bytes", "alltoall_s")


class ClosedRunner(Driver):

    def inputs(self) -> list[dict]:
        """The requests' scans, sent in turn; sets ``self.rows``."""
        t = self.traffic
        self.rows = int(t["rows_per_request"])
        return self.band_pool(self.model(), self.rows, int(t["pool_bands"]))

    def transport(self):
        return self.prog.CudaTransport(self.device, compile_cache=self.cache)

    def setup(self) -> None:
        t0 = now()
        self.pool = self.inputs()
        self.span("setup.scans", t0, now())
        for d in self.devices():
            torch.cuda.reset_peak_memory_stats(d)
        self.cache = self.prog.CompileCache()
        self.next = 0
        t0 = now()
        for _ in range(int(self.traffic["warmup_requests"])):
            r = self.one(-1, now())
            if not r.ok:
                raise RuntimeError(f"warm-up request failed: {r.error}")
        self.span("setup.warmup", t0, now())

    def one(self, index: int, due: float) -> Request:
        scan = self.pool[self.next % len(self.pool)]
        self.next += 1
        pl = program.chain(self.prog, self.config, scan)
        transport = self.transport()
        start = now()
        spans, stats, t_run = [], {}, None
        try:
            runner = self.prog.PluginRunner(pl, transport)
            datasets = runner.run()
            t_run = now()
            vol = transport.read(datasets[self.config["result"]])
            end = now()
            spans = program_spans(runner.profiler.trace)
            stats = transport.stats()
            ok = tuple(vol.shape) == (self.rows, self.out_size, self.out_size)
            err = None if ok else f"volume of shape {vol.shape}"
        except Exception as e:          # noqa: BLE001 — a failed request
            end, ok, err, vol = now(), False, repr(e), None
        if index >= 0:
            self.span("request", start, end)
            if t_run is not None:
                self.span("runner.run", start, t_run)
                self.span("transport.read", t_run, end)
            if ok:
                self.sample.offer(index, (vol, scan))
        r = Request(index, due, start, end, ok, self.rows if ok else 0,
                    spans, self.work(self.rows), err)
        r.stats = {k: float(stats[k]) for k in STATS if k in stats}
        return r

    def window(self) -> Record:
        reqs = []
        t0 = now()
        deadline = t0 + self.seconds
        while now() < deadline:
            reqs.append(self.one(len(reqs), now()))
        t1 = max([r.end for r in reqs] + [t0])
        stats = {k: sum(r.stats.get(k, 0.0) for r in reqs) for k in STATS
                 if any(k in r.stats for r in reqs)}
        return Record(self.cell.name, self.cell.chips, t0, t1, reqs,
                      self.host_spans, stats)

    def free(self) -> None:
        self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def slices_per_request(self) -> int:
        return int(self.traffic["check"]["slices_per_request"])

    def check(self, record: Record, modes=(None,)):
        per = self.slices_per_request()
        items = []
        for index, (vol, scan) in sorted(self.sample.kept,
                                         key=lambda kv: kv[0]):
            rows = self.pick_slices(self.rows, per, index)
            items.append((vol[rows], scan, rows, None))
        return self.compare(items, modes)


DRIVER = ClosedRunner
