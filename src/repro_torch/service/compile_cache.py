"""Process-level built-step cache, shared by every job's transport.

The paper's headline workload is "the same pipeline over many datasets":
at a facility, hundreds of scans a day run one tuned process list.  The
service keeps ONE cache for the whole process, shared by every job's
:class:`~repro_torch.core.transport.CudaTransport`, so a resubmitted
process list finds every plugin step already built.

Keys come from ``CudaTransport._plugin_key``: (plugin static identity,
in/out dataset shapes/dtypes/patterns, constants structure, driver,
device).  Values are built steps whose setup-derived constants
(dark/flat fields, filter banks...) are arguments, so a hit is valid
across jobs even when calibration data differs.  A step's kernels are
built once per process by ``kernels.build``; what this cache saves is
the step's construction and the hit/miss accounting the service
reports.

The cache also keeps each step's cost profile
(``CudaTransport.plugin_cost``), so with cost analysis on a distinct
step is measured once per process, not once per job.

Thread-safety: one build per key even under concurrent misses — losers
of the build race block on the winner's per-key event rather than
building twice.  Cost measurements run one at a time, under their own
lock.  :meth:`CompileCache.clear` bumps a generation counter
so a build that was already in flight when the clear happened cannot
re-insert its (now unwanted) entry afterwards.

The port's counterpart of ``repro.service.compile_cache.CompileCache``,
in-memory tier only: the persistent tier (``ExecutableStore``, the
``fetch``/``publish`` callbacks) serves broker-mode workers and comes
after them (ROADMAP.md "Next" D3).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..obs.trace import current_trace

#: where the persistent tier is tracked
_PERSISTENT_TIER = ("the compile cache's persistent tier is not ported "
                    "yet (ROADMAP.md \"Next\" D3, after the broker-mode "
                    "workers of D1)")


class CompileCache:
    """Process-level built-step cache (paper §I: "the same pipeline,
    many datasets" — resubmission must not rebuild)."""

    def __init__(self, max_entries: int | None = None, store=None,
                 fetch: Callable[[str], bytes | None] | None = None,
                 publish: Callable[[str, bytes], Any] | None = None):
        """Args:
            max_entries: FIFO-evict beyond this many built steps (None =
                unbounded).
            store, fetch, publish: the persistent tier's arguments in
                the JAX package; passing any of them raises
                NotImplementedError."""
        if store is not None or fetch is not None or publish is not None:
            raise NotImplementedError(_PERSISTENT_TIER)
        self.max_entries = max_entries
        self._entries: dict[Any, Any] = {}
        self._building: dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self._generation = 0
        self._costs: dict[Any, Any] = {}
        self._cost_lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_s = 0.0               # total wall spent building

    def get_or_build(self, key, builder: Callable[[], Any]):
        """Return the cached value for ``key``, building it (once) on a
        miss.

        Args:
            key: hashable identity (``CudaTransport._plugin_key``).
            builder: zero-arg callable producing the step; invoked at
                most once per key even under concurrent misses — losers
                of the build race block on the winner.

        Returns: the cached/built value.  A ``builder`` that raises
        propagates to its caller; waiting losers retry (and one of them
        becomes the next builder).
        """
        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    return self._entries[key]
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self.misses += 1
                    # snapshot the generation BEFORE building: a clear()
                    # issued mid-build bumps it, and the late winner
                    # below must then be dropped, not re-inserted
                    gen = self._generation
                    break
            ev.wait()                    # someone else is building this key
        try:
            t0 = time.perf_counter()
            t0_epoch = time.time()
            fn = builder()
            dt = time.perf_counter() - t0
            tr = current_trace()
            if tr is not None:
                # actual builds (never hits) show up as ``compile`` spans
                # on whichever job triggered them
                tr.record("compile", t0_epoch, t0_epoch + dt,
                          attrs={"kind": key[0] if isinstance(key, tuple)
                                 and key else "plugin"})
            with self._lock:
                self.build_s += dt
                if self._generation != gen:
                    # cleared while we were building: hand the step to
                    # the caller (it is still correct for THIS call) but
                    # never cache it
                    return fn
                self._entries[key] = fn
                if (self.max_entries is not None
                        and len(self._entries) > self.max_entries):
                    # FIFO eviction — steps are all roughly the same
                    # size; recency tracking is not worth the locking
                    oldest = next(iter(self._entries))
                    del self._entries[oldest]
                    self.evictions += 1
            return fn
        finally:
            with self._lock:
                self._building.pop(key).set()

    def cost(self, key, measure: Callable[[], Any]):
        """The cost profile of step ``key``: ``measure()`` on a miss,
        run while no other measurement runs (a measurement is an extra
        run of the step), then kept for every later caller."""
        with self._cost_lock:
            if key not in self._costs:
                self._costs[key] = measure()
            return self._costs[key]

    def clear(self) -> None:
        """Drop every cached step (counters are kept), including builds
        currently in flight: the generation bump makes a pre-clear
        builder's late insert a no-op."""
        with self._lock:
            self._generation += 1
            self._entries.clear()

    def stats(self) -> dict[str, Any]:
        """Counters: ``hits``, ``misses``, ``entries``, ``evictions``,
        total ``build_s`` and the clear ``generation``."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries),
                    "evictions": self.evictions,
                    "build_s": round(self.build_s, 4),
                    "generation": self._generation}
