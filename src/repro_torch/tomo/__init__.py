# Tomography substrate: the paper's own domain (full-field parallel-beam
# CT) — geometry, synthetic scans, and the standard processing plugins.
from .geometry import ParallelGeometry
from .phantom import (forward_project, phantom_stack, shepp_logan,
                      simulate_raw_scan)
from .plugins import (DarkFlatCorrection, Downsample, FBPRecon,
                      HDF5LikeSaver, PaganinFilter, Quantify, RingRemoval,
                      SinogramFilter, SyntheticTomoLoader, UpstreamLoader)

__all__ = [
    "ParallelGeometry", "shepp_logan", "phantom_stack", "forward_project",
    "simulate_raw_scan", "SyntheticTomoLoader", "DarkFlatCorrection",
    "PaganinFilter", "RingRemoval", "SinogramFilter", "FBPRecon",
    "HDF5LikeSaver", "UpstreamLoader", "Downsample", "Quantify",
    "standard_chain",
]


def standard_chain(n_det: int = 64, n_angles: int = 64, n_rows: int = 4,
                   *, paganin: bool = False, ring: bool = True,
                   noise: float = 0.0, use_pallas: bool = True,
                   seed: int = 0, device: str = "cuda"):
    """The paper's typical full-field process list (Figs 5–7):
    loader → correction → [paganin] → [ring removal] → sino filter →
    FBP → saver, all on one dataset name ('tomo').  ``seed`` varies the
    simulated scan; ``device`` is where the loader simulates it.
    ``use_pallas`` (the JAX package's name) asks for the hand-written
    kernels; False asks for the plain PyTorch versions."""
    from ..core.process_list import ProcessList
    pl = ProcessList()
    pl.add(SyntheticTomoLoader,
           params={"n_det": n_det, "n_angles": n_angles, "n_rows": n_rows,
                   "noise": noise, "seed": seed, "device": device},
           out_datasets=("tomo",))
    pl.add(DarkFlatCorrection, params={"use_pallas": use_pallas},
           in_datasets=("tomo",), out_datasets=("tomo",))
    if paganin:
        pl.add(PaganinFilter, in_datasets=("tomo",), out_datasets=("tomo",))
    if ring:
        pl.add(RingRemoval, in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(SinogramFilter, params={"use_pallas": use_pallas},
           in_datasets=("tomo",), out_datasets=("tomo",))
    pl.add(FBPRecon, params={"use_pallas": use_pallas},
           in_datasets=("tomo",), out_datasets=("recon",))
    pl.add(HDF5LikeSaver, in_datasets=("recon",))
    return pl
