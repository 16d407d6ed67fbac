"""Roofline terms of a step from its per-device counts.

Per (arch × shape × mesh):

    compute_s    = flops_per_device / PEAK_FLOPS
    memory_s     = bytes_per_device / HBM_BW
    collective_s = Σ collective_bytes_per_device / ICI_BW_EFF

The counts come from :class:`~.counter.Counter` (the port's counterpart
of the reference's XLA ``cost_analysis`` and HLO parse): flops, bytes
and each collective's output bytes on one device, with an all-reduce
counted twice (its reduce-scatter and all-gather phases).

Hardware model, one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
989 TFLOP/s bf16 on the tensor cores, 80 GB of HBM3 at 3.35 TB/s.  The collective
term keeps the reference's single constant, and takes the per-GPU
*inter-node* rate: a 16-way mesh axis spans two 8-GPU nodes, so its
ring crosses the node boundary, where each GPU has one 400 Gb/s
InfiniBand NDR port (50 GB/s per direction, the DGX H100 layout); at the
reference's 90 % ring efficiency that is 45 GB/s.  NVLink inside a node
(450 GB/s per direction) only makes the term conservative for an axis
that stays inside one node.
"""
from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989e12          # bf16 per card, dense
HBM_BW = 3.35e12             # bytes/s per card
ICI_BW_EFF = 45e9            # effective bytes/s on the collective path
HBM_BYTES = 80 * 10**9       # the card's memory (80 GB), what a cell fits


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device, weighted
    coll_detail: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0     # 6·N·D (global)
    useful_ratio: float = 0.0    # model / (counted × devices)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyse(counts: Any, *, n_devices: int,
            model_flops: float = 0.0) -> Roofline:
    """The roofline terms of ``counts``: a :class:`~.counter.Counter`
    or its ``as_dict()`` (``flops``, ``bytes``, ``collective_bytes``,
    ``coll_detail``), per device."""
    if hasattr(counts, "as_dict"):
        counts = counts.as_dict()
    flops = float(counts["flops"])
    byts = float(counts["bytes"])
    weighted = float(counts["collective_bytes"])
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = weighted / ICI_BW_EFF
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops / (flops * n_devices)
              if flops and model_flops else 0.0)
    return Roofline(flops, byts, weighted, dict(counts["coll_detail"]),
                    compute_s, memory_s, coll_s, bottleneck, model_flops,
                    useful)


def summarise(r: Roofline) -> str:
    return (f"compute={r.compute_s * 1e3:8.2f}ms  "
            f"memory={r.memory_s * 1e3:8.2f}ms  "
            f"collective={r.collective_s * 1e3:8.2f}ms  "
            f"bottleneck={r.bottleneck:10s}  useful={r.useful_ratio:.2f}")
