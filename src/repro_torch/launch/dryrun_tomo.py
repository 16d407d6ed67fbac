"""Dry-run of the paper's OWN workload at production scale: a
full-field scan of (3072 angles × 2048 rows × 2048 det) — the paper's
"typical single scan ≈ 96 GB" scaled to power-of-two dims (25 GB u16
raw, 50 GB fp32 working set) — through the correction → ring-removal →
sinogram-filter chain, traced on the 256-card production mesh with
pattern-driven placements.

The dataset is a DTensor placed by its pattern (the first slice dim over
``data``, ``Pattern.to_spec``, the reference's ``Pattern.to_pspec``
rule, by which ``ShardedTransport`` splits it over real slots); each plugin runs on the local shard (the reference's
``shard_map``: frame math is shard-local, the transform axes are core
dims), and each PROJECTION → SINOGRAM transition is a ``redistribute``,
which the cards run as an all-to-all.  The plugins take their plain
paths on fake tensors; the correction's and the spectrum scale's work is
counted through their kernels' ``cost()``.  Savu paid the transition as
a parallel-HDF5 round trip.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_tomo
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.dataset import DataSet
from ..core.patterns import PROJECTION, SINOGRAM, Pattern
from ..core.plugin import PluginData
from ..core.transport import _PeakMemory
from ..models.sharding import distribute, spec_placements
from ..roofline.analysis import analyse
from ..roofline.counter import Counter
from ..tomo.geometry import ParallelGeometry
from ..tomo.plugins import DarkFlatCorrection, RingRemoval, SinogramFilter
from .mesh import fake_tensors, production_mesh

N_ANGLES, N_ROWS, N_DET = 3072, 2048, 2048   # paper's ~3k angles,
#   rounded to divide the 16-way data axis


def _dataset(name: str, shape: tuple[int, int, int]) -> DataSet:
    ds = DataSet(name, shape, np.float32,
                 ("rotation_angle", "detector_y", "detector_x"))
    ds.add_pattern(PROJECTION, core=("detector_y", "detector_x"),
                   slice_=("rotation_angle",))
    ds.add_pattern(SINOGRAM, core=("rotation_angle", "detector_x"),
                   slice_=("detector_y",))
    return ds


def _chain(n_angles: int, n_rows: int, n_det: int, use_pallas: bool):
    geom = ParallelGeometry(n_angles, n_det, n_rows)
    raw = _dataset("tomo", (n_angles, n_rows, n_det))
    raw.metadata.update({
        "dark": np.full((n_rows, n_det), 96.0, np.float32),
        "flat": np.full((n_rows, n_det), 40000.0, np.float32),
        "mu": 0.02, "geometry": geom})
    plugins = [
        DarkFlatCorrection(in_datasets=["tomo"], out_datasets=["tomo"],
                           use_pallas=use_pallas),
        RingRemoval(in_datasets=["tomo"], out_datasets=["tomo"]),
        SinogramFilter(in_datasets=["tomo"], out_datasets=["tomo"],
                       use_pallas=use_pallas),
    ]
    cur = raw
    for p in plugins:
        p.in_data = [PluginData(cur)]
        p.out_data = []
        (out,) = p.setup([cur])
        out.name = p.out_dataset_names[0]
        p.out_data = [PluginData(out)]
        p.out_data[0].pattern_name = (p.out_pattern_name
                                      or p.in_data[0].pattern_name)
        p.out_data[0].n_frames = p.in_data[0].n_frames
        if p.out_data[0].pattern_name not in out.patterns:
            out.patterns.update(cur.patterns)
        cur = out
    return raw, plugins


def _run_local(p, x: DTensor) -> DTensor:
    """One plugin on this rank's shard (all its frames at once, as the
    transport runs a per-frame plugin), placed as its input was."""
    pat_in, pat_out = p.in_data[0].pattern, p.out_data[0].pattern
    local = x.to_local()
    res = p.process_frames([pat_in.to_frames(local)])
    out = pat_out.from_frames(res, local.shape).to(torch.float32)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)


def lower_chain(mesh, *, n_angles: int = N_ANGLES, n_rows: int = N_ROWS,
                n_det: int = N_DET, use_pallas: bool = False) -> dict:
    """Trace the chain on ``mesh`` with fake tensors; return its record:
    memory per device, the roofline terms, the collectives DTensor
    inserted and the pattern transitions."""
    # imported here: importing torch's debug package sets an environment
    # variable (TORCHINDUCTOR_CACHE_DIR), which no import of the port may
    from torch.distributed.tensor.debug import CommDebugMode
    raw, plugins = _chain(n_angles, n_rows, n_det, use_pallas)
    shape = raw.shape
    transitions = 0
    with fake_tensors():
        x = distribute(torch.zeros(shape, dtype=torch.float32), mesh,
                       spec_placements(
                           mesh, raw.get_pattern(PROJECTION).to_spec()))
        argument_bytes = x.to_local().numel() * 4
        with Counter() as counts, CommDebugMode() as comm, \
                _PeakMemory(torch.device(mesh.device_type)) as mem:
            cur = x
            for p in plugins:
                want = spec_placements(mesh,
                                       p.in_data[0].pattern.to_spec())
                if list(cur.placements) != want:
                    transitions += 1
                    cur = cur.redistribute(mesh, want)
                cur = _run_local(p, cur)
            out_local_bytes = cur.to_local().numel() * 4
            del cur
    roof = analyse(counts, n_devices=mesh.size())
    return {
        "tag": f"tomo-fullfield-chain__{n_angles}x{n_rows}x{n_det}",
        "mesh": list(mesh.shape),
        "dataset_gb": n_angles * n_rows * n_det * 4 / 1e9,
        "memory": {
            "argument_bytes": argument_bytes,
            "temp_bytes": mem.peak,
            "peak_estimate": argument_bytes + mem.peak,
        },
        "local_dataset_bytes": out_local_bytes,
        "transitions": transitions,
        "comm_counts": {str(k): v for k, v in
                        comm.get_comm_counts().items()},
        "roofline": roof.to_json(),
    }


def main() -> None:
    with production_mesh() as mesh:
        rec = lower_chain(mesh)
    os.makedirs("experiments/dryrun", exist_ok=True)
    with open("experiments/dryrun/tomo_chain_pod.json", "w") as fh:
        json.dump(rec, fh, indent=1)
    ro = rec["roofline"]
    print(f"{rec['tag']}: {rec['dataset_gb']:.0f} GB fp32 working set, "
          f"peak/dev={rec['memory']['peak_estimate'] / 2**30:.2f} GiB")
    print(f"  compute={ro['compute_s'] * 1e3:.1f}ms "
          f"memory={ro['memory_s'] * 1e3:.1f}ms "
          f"collective={ro['collective_s'] * 1e3:.1f}ms "
          f"-> {ro['bottleneck']}")
    print("  (the PROJECTION->SINOGRAM pattern transition is the "
          "collective term: Savu paid it as a parallel-HDF5 round trip)")


if __name__ == "__main__":
    main()
