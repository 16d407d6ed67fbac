"""Tomography processing plugins — the paper's standard full-field chain
(§II.A): correction/linearisation → (ring removal | Paganin phase
retrieval) → sinogram filtering → FBP reconstruction.

Every plugin is a thin Savu-style shell over a kernels/ op (a
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU) or plain PyTorch; the framework owns the slicing per the declared
pattern.  ``process_frames`` takes a block of frames (any number of
them) as a tensor with the frames leading.  Setup-derived constants are
CPU tensors; the transport moves them to its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataSet
from ..core.patterns import PROJECTION, SINOGRAM, TIMESERIES, VOLUME_XZ
from ..core.plugin import BaseFilter, BaseLoader, BaseRecon, BaseSaver
from ..kernels.backproject.ops import backproject
from ..kernels.correction.ops import correct
from ..kernels.sino_filter.ops import filter_sino
from ..kernels.sino_filter.ref import make_filter
from .geometry import ParallelGeometry
from .phantom import phantom_stack, simulate_raw_scan


class SyntheticTomoLoader(BaseLoader):
    """Creates a raw full-field scan (θ, y, x) from a phantom — the
    nx_tomo_loader analogue, with dark/flat fields in metadata.  The
    scan is simulated on ``device``; a ``scan`` dict of numpy arrays
    (``data``, ``dark``, ``flat``...) is taken as it is."""

    name = "synthetic_tomo_loader"
    parameters = {"n_det": 64, "n_angles": 64, "n_rows": 4, "noise": 0.0,
                  "seed": 0, "scan": None, "device": "cuda"}
    data_params = ("seed", "scan")      # dataset identity, not pipeline

    def load(self) -> list[DataSet]:
        p = self.params
        scan = p["scan"]
        if scan is None:
            geom = ParallelGeometry(p["n_angles"], p["n_det"], p["n_rows"])
            vol = phantom_stack(p["n_det"], p["n_rows"])
            scan = simulate_raw_scan(vol, geom, noise=p["noise"],
                                     seed=p["seed"], device=p["device"])
        else:
            geom = ParallelGeometry(scan["data"].shape[0],
                                    scan["data"].shape[2],
                                    scan["data"].shape[1])
        data = scan["data"]
        ds = DataSet(self.out_dataset_names[0], data.shape, data.dtype,
                     ("rotation_angle", "detector_y", "detector_x"),
                     backing=lambda: data)      # lazy (paper §III.F.2)
        ds.add_pattern(PROJECTION, core=("detector_y", "detector_x"),
                       slice_=("rotation_angle",))
        ds.add_pattern(SINOGRAM, core=("rotation_angle", "detector_x"),
                       slice_=("detector_y",))
        ds.metadata.update({
            "dark": scan["dark"], "flat": scan["flat"],
            "mu": scan.get("mu", 1.0), "geometry": geom,
            "truth": scan.get("truth"),
        })
        return [ds]


class DarkFlatCorrection(BaseFilter):
    """(raw−dark)/(flat−dark), clip, −log — fused CUDA kernel.

    ``use_pallas`` asks for the hand-written kernel (the JAX package's
    parameter name, so its process lists load unchanged); False asks for
    the plain PyTorch version."""

    name = "dark_flat_correction"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"use_pallas": True}

    def setup(self, in_datasets):
        (din,) = in_datasets
        self._dark = torch.as_tensor(
            np.asarray(din.metadata["dark"]).astype(np.float32))
        self._flat = torch.as_tensor(
            np.asarray(din.metadata["flat"]).astype(np.float32))
        dout = din.like(self.out_dataset_names[0], dtype=np.float32)
        dout.metadata = dict(din.metadata)
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, y, x), raw dtype (uint16)
        return correct(block, self._dark, self._flat,
                       use_pallas=self.params["use_pallas"])

    def process_frames_batched(self, frames, consts, counts):
        """A gang's frames (member j's ``counts[j]`` after member
        j - 1's), each member with its own dark and flat: one launch."""
        (block,) = frames
        return correct(block, torch.stack([c["_dark"] for c in consts]),
                       torch.stack([c["_flat"] for c in consts]),
                       counts=counts, use_pallas=self.params["use_pallas"])


class PaganinFilter(BaseFilter):
    """Single-distance phase retrieval (Paganin 2002) — projection-space
    low-pass:  T = −ln( F⁻¹[ F[I] / (1 + τ(kx²+ky²)) ] )."""

    name = "paganin_filter"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"tau": 10.0}   # δ·z/μ lumped constant, pixel units
    # tau only shapes self._denom (a constant), so it is sweepable
    tunable_params = ("tau",)

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0], dtype=np.float32)
        dout.metadata = dict(din.metadata)
        ny, nx = din.shape[1], din.shape[2]
        ky = np.fft.fftfreq(ny)[:, None]
        kx = np.fft.fftfreq(nx)[None, :]
        self._denom = torch.as_tensor(
            (1.0 / (1.0 + self.params["tau"] * (kx ** 2 + ky ** 2)))
            .astype(np.complex64))
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, y, x) — already −log corrected
        intensity = torch.exp(-block)          # back to transmission
        spec = torch.fft.fft2(intensity.to(torch.complex64), dim=(1, 2))
        filt = torch.fft.ifft2(spec * self._denom[None], dim=(1, 2)).real
        return -torch.log(torch.clamp(filt, min=1e-6))


class RingRemoval(BaseFilter):
    """Sinogram-space stripe suppression: subtract the smoothed column
    mean (a standard mean-filter ring-removal; operates per sinogram)."""

    name = "ring_removal"
    pattern_name = SINOGRAM
    frames = 1
    parameters = {"kernel": 9, "strength": 1.0}
    # strength scales the correction as a float constant, so it is
    # sweepable; kernel selects shapes and stays static
    tunable_params = ("strength",)

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0], dtype=np.float32)
        dout.metadata = dict(din.metadata)
        self._strength = float(self.params["strength"])
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, angles, x)
        col_mean = torch.mean(block, dim=1, keepdim=True)   # (m, 1, x)
        k = int(self.params["kernel"])
        pad = k // 2
        padded = torch.cat([col_mean[..., :1].expand(-1, -1, pad), col_mean,
                            col_mean[..., -1:].expand(-1, -1, pad)], dim=-1)
        # moving mean over windows of k ("valid" convolution with a box);
        # written as a windowed sum, not a conv1d, which cuDNN would run
        # in TF32
        kern = torch.full((k,), 1.0 / k, dtype=block.dtype,
                          device=block.device)
        smooth = (padded.unfold(-1, k, 1) * kern).sum(dim=-1)
        stripe = col_mean - smooth
        return block - self._strength * stripe


class SinogramFilter(BaseFilter):
    """Frequency-domain ramp filtering of sinogram rows (FBP step 1)."""

    name = "sinogram_filter"
    pattern_name = SINOGRAM
    frames = 1
    # cutoff: fraction of Nyquist above which the response is zeroed —
    # the classic Savu tuning knob; it only shapes self._filt
    parameters = {"kind": "shepp", "use_pallas": True, "cutoff": 1.0}
    tunable_params = ("cutoff",)

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0], dtype=np.float32)
        dout.metadata = dict(din.metadata)
        n_det = din.shape[din.label_index("detector_x")]
        filt = make_filter(n_det, self.params["kind"])
        cutoff = float(self.params["cutoff"])
        nyq_frac = np.linspace(0.0, 1.0, filt.shape[0], dtype=np.float32)
        filt = (filt * (nyq_frac <= cutoff)).astype(np.float32)
        self._filt = torch.as_tensor(filt)
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, angles, x)
        return filter_sino(block, self._filt,
                           use_pallas=self.params["use_pallas"])


class FBPRecon(BaseRecon):
    """Filtered backprojection — sinogram in, volume slice out (CUDA
    gather kernel; the chain's compute hot spot)."""

    name = "fbp_recon"
    n_in_datasets = 1
    n_out_datasets = 1
    out_pattern_name = VOLUME_XZ
    parameters = {"use_pallas": True, "out_size": None}

    def setup(self, in_datasets):
        (din,) = in_datasets
        n_angles = din.shape[din.label_index("rotation_angle")]
        n_det = din.shape[din.label_index("detector_x")]
        n_rows = din.shape[din.label_index("detector_y")]
        out_size = self.params["out_size"] or n_det
        self._out_size = out_size
        geom: ParallelGeometry = din.metadata["geometry"]
        # the input's angle count, so an angle prefix of a scan
        # reconstructs from exactly the acquired angles
        self._angles = torch.as_tensor(
            geom.angles.astype(np.float32)[:n_angles])
        self._mu = float(din.metadata.get("mu", 1.0))
        dout = DataSet(self.out_dataset_names[0],
                       (n_rows, out_size, out_size), np.float32,
                       ("voxel_y", "voxel_z", "voxel_x"))
        dout.add_pattern(VOLUME_XZ, core=("voxel_z", "voxel_x"),
                         slice_=("voxel_y",))
        dout.metadata = dict(din.metadata)
        for pd in self.in_data:
            pd.pattern_name = SINOGRAM
            pd.n_frames = 1
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, angles, x)
        img = backproject(block, self._angles, self._out_size,
                          use_pallas=self.params["use_pallas"])
        return img / self._mu      # linearised path -> attenuation units


class UpstreamLoader(BaseLoader):
    """Workflow stage input: loads another job's result volume as this
    chain's starting dataset.  By ``load()`` time exactly one of ``data``
    (an array) or ``path`` (an ``.npy`` file) is given."""

    name = "upstream_loader"
    parameters = {"from_job": None, "dataset": None, "data": None,
                  "path": None}
    data_params = ("from_job", "dataset", "data", "path")

    def load(self) -> list[DataSet]:
        p = self.params
        data = p["data"]
        if isinstance(data, dict):
            raise RuntimeError(
                f"upstream_loader: unresolved upstream reference {data!r} "
                f"— it must be resolved to an array before the chain runs")
        if data is None and p["path"]:
            data = np.load(p["path"])
        if data is None:
            raise RuntimeError(
                "upstream_loader: no input — neither a resolved 'data' "
                "array nor a 'path' was provided")
        arr = np.asarray(data)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3:
            raise RuntimeError(
                f"upstream_loader: expected a (y, z, x) volume, got "
                f"shape {arr.shape}")
        ds = DataSet(self.out_dataset_names[0], arr.shape, arr.dtype,
                     ("voxel_y", "voxel_z", "voxel_x"),
                     backing=lambda: arr)
        ds.add_pattern(VOLUME_XZ, core=("voxel_z", "voxel_x"),
                       slice_=("voxel_y",))
        return [ds]


class Downsample(BaseFilter):
    """Block-mean downsampling of a reconstructed volume's in-plane
    dims — the post-recon reduction stage."""

    name = "downsample"
    pattern_name = VOLUME_XZ
    frames = 1
    parameters = {"factor": 2}

    def setup(self, in_datasets):
        (din,) = in_datasets
        f = int(self.params["factor"])
        if f < 1:
            raise ValueError(f"downsample: factor must be >= 1, got {f}")
        y = din.shape[din.label_index("voxel_y")]
        z = din.shape[din.label_index("voxel_z")]
        x = din.shape[din.label_index("voxel_x")]
        if z % f or x % f:
            raise ValueError(
                f"downsample: factor {f} must divide the in-plane dims "
                f"({z}, {x})")
        dout = DataSet(self.out_dataset_names[0], (y, z // f, x // f),
                       np.float32, ("voxel_y", "voxel_z", "voxel_x"))
        dout.add_pattern(VOLUME_XZ, core=("voxel_z", "voxel_x"),
                         slice_=("voxel_y",))
        dout.metadata = dict(din.metadata)
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, z, x)
        f = int(self.params["factor"])
        m, z, x = block.shape
        return torch.mean(
            block.reshape(m, z // f, f, x // f, f).to(torch.float32),
            dim=(2, 4))


class Quantify(BaseFilter):
    """Per-slice summary statistics (mean/std/min/max) of a volume."""

    name = "quantify"
    n_in_datasets = 1
    n_out_datasets = 1
    out_pattern_name = TIMESERIES
    parameters: dict = {}

    def setup(self, in_datasets):
        (din,) = in_datasets
        y = din.shape[din.label_index("voxel_y")]
        dout = DataSet(self.out_dataset_names[0], (y, 4), np.float32,
                       ("voxel_y", "stat"))
        dout.add_pattern(TIMESERIES, core=("stat",), slice_=("voxel_y",))
        dout.metadata = dict(din.metadata)
        for pd in self.in_data:
            pd.pattern_name = VOLUME_XZ
            pd.n_frames = 1
        return [dout]

    def process_frames(self, frames):
        (block,) = frames          # (m, z, x)
        flat = block.reshape(block.shape[0], -1).to(torch.float32)
        return torch.stack([torch.mean(flat, dim=1),
                            torch.std(flat, dim=1, correction=0),
                            torch.amin(flat, dim=1),
                            torch.amax(flat, dim=1)], dim=-1)


class HDF5LikeSaver(BaseSaver):
    """Terminal saver: flushes chunked files and records the manifest
    entry (the NeXus-link analogue)."""

    name = "hdf5_saver"

    def save(self, dataset: DataSet) -> None:
        backing = dataset.backing
        if hasattr(backing, "flush"):
            backing.flush()
        dataset.metadata["saved"] = True
