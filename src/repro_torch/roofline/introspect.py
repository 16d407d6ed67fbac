"""Collective introspection: per-(type, shape) weighted byte totals —
the profile for finding which collective dominates a cell.  The
reference reads them from HLO with loop multipliers; the port's
:class:`~.counter.Counter` saw every collective as it ran (loops
unrolled), so this only weights and ranks what it recorded."""
from __future__ import annotations

from typing import Any


def collective_profile(counts: Any, top: int = 12) -> list[tuple]:
    """``[("<type> <dtype>[<shape>]", weighted bytes), ...]`` of the
    ``top`` largest, an all-reduce weighted 2×.  ``counts`` is a
    :class:`~.counter.Counter` or its ``coll_ops`` mapping."""
    ops = getattr(counts, "coll_ops", counts)
    total = {f"{kind} {shape}": nbytes * (2 if kind == "all-reduce" else 1)
             for (kind, shape), nbytes in ops.items()}
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]
