"""Per-thread record of the kernel work a block of code does.

Each public op notes the work of one call of its kernel's function (the
kernel's ``cost()`` counts, whichever route computed it, and whether the
kernel itself was launched) into every tally open on the calling
thread.  A launch is counted here and nowhere else: :func:`note` also
adds it to the wrapper's process-wide ``launches`` count.  ``CudaTransport.plugin_cost`` reads the flops and bytes of a
step's run; the runner and the gang scheduler read the launches made
inside a step's ``process`` span, and the frame blocks a built step
ran in (:func:`note_blocks`).  A count is computed only when an open
tally asks for costs, so the launch tallies around every step cost
nothing more than a dictionary update per launch.

A plain version runs inside :func:`plain_version`, which notes its call
and marks the block, so a per-op counter (``roofline.counter``) reads
the call's work from ``cost()`` and not from the plain version's ops.

Tallies are thread-local: the service's worker threads each record their
own steps.  The process-wide counts are updated under a lock.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

from torch.utils._python_dispatch import _disable_current_modes

_STATE = threading.local()
_LAUNCHES_LOCK = threading.Lock()


class Tally:
    """What the ops called inside one ``with tally(...)`` block did."""

    def __init__(self, costs: bool):
        self.costs = costs
        self.flops = 0.0
        self.bytes = 0.0
        #: kernel name -> launches of the hand-written kernel
        self.launches: dict[str, int] = {}
        #: the most frame blocks one call of a built step ran in
        self.blocks = 1

    def launch_attrs(self) -> dict[str, int]:
        """The launches as span attributes, ``launches.<kernel>``, and
        ``blocks``."""
        return {**{f"launches.{k}": n
                   for k, n in sorted(self.launches.items())},
                "blocks": self.blocks}


@contextlib.contextmanager
def tally(costs: bool = False) -> Iterator[Tally]:
    """Open a tally on this thread; with ``costs`` it also sums the
    flops and bytes of every op called in it."""
    outer = getattr(_STATE, "open", ())
    t = Tally(costs)
    _STATE.open = outer + (t,)
    try:
        yield t
    finally:
        _STATE.open = outer


def note(name: str, cost: Callable[[], dict[str, float]],
         wrapper: Callable | None = None) -> None:
    """Record one call of kernel ``name``'s function: ``cost`` gives its
    ``{"flops", "bytes"}`` (called only if an open tally sums costs);
    ``wrapper`` is the kernel's wrapper when it launched the hand-written
    kernel (its ``launches`` count goes up by one), None when the plain
    version computed the call."""
    if wrapper is not None:
        with _LAUNCHES_LOCK:
            wrapper.launches += 1
    open_ = getattr(_STATE, "open", ())
    if not open_:
        return
    work = None
    if any(t.costs for t in open_):
        # the count's own tensor ops are no part of the step: no dispatch
        # mode that reads the step (flops, peak memory) sees them
        with _disable_current_modes():
            work = cost()
    for t in open_:
        if wrapper is not None:
            t.launches[name] = t.launches.get(name, 0) + 1
        if t.costs:
            t.flops += work["flops"]
            t.bytes += work["bytes"]


def note_blocks(n: int) -> None:
    """Record that a built step ran its frames in ``n`` blocks (1: in
    one call) into every tally open on this thread."""
    for t in getattr(_STATE, "open", ()):
        t.blocks = max(t.blocks, n)


@contextlib.contextmanager
def plain_version(name: str, cost: Callable[[], dict[str, float]]
                  ) -> Iterator[None]:
    """Run kernel ``name``'s plain version in the block: notes one call
    (no launch) and marks the block as the plain version's ops."""
    note(name, cost)
    _STATE.plain = getattr(_STATE, "plain", 0) + 1
    try:
        yield
    finally:
        _STATE.plain -= 1


def in_plain_version() -> bool:
    """Whether the calling thread is inside a kernel's plain version."""
    return getattr(_STATE, "plain", 0) > 0
