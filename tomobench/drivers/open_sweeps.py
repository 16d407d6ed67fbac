"""Open loop: parameter sweeps arriving as a Poisson process at a fixed
rate, each expanded by ``service.sweep.expand_sweep`` and admitted with
``JobQueue.submit_many`` to an in-process ``PipelineScheduler``.

The traffic mix gives ``rate_per_s``, ``rows_per_request`` (a sweep's
band), ``pool_bands`` (distinct bands of the seed's scan; each arrival
takes one, drawn by the seed), ``sweep`` (``plugin``, ``param``,
``values``), the scheduler's ``workers``, ``batch_identical``,
``batch_max`` and ``max_history``, ``warmup_requests``, ``drain_s``
(how long past the window's close a due request is waited for) and
``check``.

The arrivals are a Poisson process drawn from the run's seed
(:func:`schedule`): independent exponential gaps, for as long as the
window lasts.  A request is due at its arrival and done when every
variant's volume is in host memory, read through the transport by a
collector thread (as a service's result download runs beside its
scheduler); its latency runs from due to done.  A request that fails, or
is not done by ``drain_s`` past the close, counts with the time until
then.  The record's window is the offered one, from the first arrival to
the close: requests done after the close are compared and traced but
complete no work inside it."""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from .. import program
from ..harness import Driver, now, program_spans, seed_words
from ..record import Record, Request


def schedule(seed: int, rate: float, seconds: float) -> list[float]:
    """Arrival offsets (s from the window's start) of one run: a Poisson
    process of ``rate`` per second, its gaps independent exponential
    draws of the seed's generator, every arrival before ``seconds``."""
    rng = np.random.default_rng(seed_words(seed, 0xA441))
    offsets, t = [], 0.0
    while t < seconds:
        offsets.append(t)
        t += float(rng.exponential(1.0 / rate))
    return offsets


class OpenSweeps(Driver):

    def setup(self) -> None:
        t = self.traffic
        self.rows = int(t["rows_per_request"])
        model = self.model()
        t0 = now()
        self.pool = self.band_pool(model, self.rows, int(t["pool_bands"]))
        self.span("setup.scans", t0, now())
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        sw = t["sweep"]
        names = [e["plugin"] for e in self.config["process_list"]]
        # the loader is entry 0 of the process list the program gets
        self.axis = self.prog.SweepAxis(1 + names.index(sw["plugin"]),
                                        sw["param"], tuple(sw["values"]),
                                        f"{sw['plugin']}.{sw['param']}")
        self.cache = self.prog.CompileCache()
        self.queue = self.prog.JobQueue(max_history=int(t["max_history"]))
        dev = self.device
        self.sched = self.prog.PipelineScheduler(
            self.queue,
            transport_factory=lambda job: self.prog.CudaTransport(
                dev, compile_cache=self.cache),
            n_workers=int(t["workers"]),
            batch_identical=bool(t["batch_identical"]),
            batch_max=int(t["batch_max"]), compile_cache=self.cache)
        self.sched.start()
        rng = np.random.default_rng(seed_words(self.seed, 0xB0B))
        self.picks = rng.integers(0, len(self.pool), 1 << 16)
        self.n_sent = 0
        t0 = now()
        for i in range(int(t["warmup_requests"])):
            req = self.submit(-1 - i, now())
            self.collect(req, now() + float(t["drain_s"]))
            if not req.ok:
                raise RuntimeError(f"warm-up sweep failed: {req.error}")
        self.span("setup.warmup", t0, now())

    # -- one sweep -------------------------------------------------------
    def submit(self, index: int, due: float) -> Request:
        scan = self.pool[int(self.picks[self.n_sent % len(self.picks)])]
        self.n_sent += 1
        base = program.chain(self.prog, self.config, scan)
        variants = self.prog.expand_sweep(base, [self.axis])
        t0 = now()
        jobs = self.queue.submit_many([pl for _, pl in variants])
        self.span("sweep.submit", t0, now())
        req = Request(index, due, math.nan, math.nan, False, 0, [],
                      self.work(self.rows * len(jobs)))
        req.jobs = jobs
        req.scan = scan
        req.cutoffs = [v[0] for v, _ in variants]
        req.lateness = t0 - due
        return req

    def collect(self, req: Request, give_up: float) -> None:
        """Wait for ``req``'s jobs, read each volume to the host."""
        vols, err = [], None
        for job in req.jobs:
            while not job.state.terminal():
                if now() > give_up:
                    err = f"{job.job_id} not done by the give-up time"
                    break
                time.sleep(0.001)
            if err:
                break
            runner = job.runner
            if job.state is not self.prog.JobState.DONE or runner is None:
                err = f"{job.job_id} {job.state.value}: {job.error}"
                break
            t0 = now()
            vols.append(runner.transport.read(
                runner.datasets[self.config["result"]]))
            self.span("transport.read", t0, now())
        req.end = now()
        starts = [j.started_at for j in req.jobs if j.started_at]
        req.start = min(starts) if starts else req.end
        for job in req.jobs:
            req.spans += program_spans(job.trace)
        n = self.out_size
        if err is None and any(tuple(v.shape) != (self.rows, n, n)
                               for v in vols):
            err = f"volumes of shapes {[v.shape for v in vols]}"
        req.ok, req.error = err is None, err
        req.slices = self.rows * len(vols) if req.ok else 0
        if req.index >= 0:
            self.span("request", req.start, req.end)
            if req.ok:
                self.sample.offer(req.index, (vols, req.scan, req.cutoffs))
        req.jobs = None

    def window(self) -> Record:
        t = self.traffic
        offsets = schedule(self.seed, float(t["rate_per_s"]), self.seconds)
        reqs: list[Request] = []
        done = threading.Event()
        t0 = now()
        give_up = t0 + self.seconds + float(t["drain_s"])

        def collector():
            i = 0
            while i < len(offsets):
                while i >= len(reqs):
                    if done.is_set() and i >= len(reqs):
                        return
                    time.sleep(0.001)
                self.collect(reqs[i], give_up)
                i += 1

        th = threading.Thread(target=collector, name="tomobench-collector")
        th.start()
        try:
            for i, off in enumerate(offsets):
                wait = t0 + off - now()
                if wait > 0:
                    time.sleep(wait)
                reqs.append(self.submit(i, t0 + off))
        finally:
            done.set()
            th.join()
        t1 = t0 + self.seconds
        lateness = [r.lateness for r in reqs]
        st = self.sched.stats()
        return Record(self.cell.name, self.cell.chips, t0, t1, reqs,
                      self.host_spans,
                      {"gangs_run": st["gangs_run"],
                       "gang_fallbacks": st["gang_fallbacks"]},
                      extra={"lateness_max_s": max(lateness, default=0.0),
                             "offered": len(offsets)})

    def free(self) -> None:
        self.sched.shutdown(wait=True)
        self.sched = self.queue = self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, record: Record, modes=(None,)):
        per = int(self.traffic["check"]["slices_per_request"])
        items = []
        for index, (vols, scan, cutoffs) in sorted(self.sample.kept,
                                                   key=lambda kv: kv[0]):
            rows = self.pick_slices(self.rows, per, index)
            for vol, cut in zip(vols, cutoffs):
                items.append((vol[rows], scan, rows, float(cut)))
        return self.compare(items, modes)


DRIVER = OpenSweeps
