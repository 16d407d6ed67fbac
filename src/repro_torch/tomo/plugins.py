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

import threading
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dataset import DataSet
from ..core.patterns import PROJECTION, SINOGRAM, TIMESERIES, VOLUME_XZ
from ..core.plugin import BaseFilter, BaseLoader, BaseRecon, BaseSaver
from ..device import resolve_device
from ..kernels.backproject.ops import backproject
from ..kernels.correction.ops import correct
from ..kernels.sino_filter.ops import filter_sino
from ..kernels.sino_filter.ref import make_filter, member_rows
from .geometry import ParallelGeometry
from .phantom import phantom_stack, simulate_raw_scan


class _Scan(dict):
    """A simulated scan (a dict, weakly referenced from :data:`_SCANS`)."""


#: simulated scans that some loader's dataset still holds, by what
#: defines them: loaders of one scan (a sweep's variants) share one
#: simulation rather than each making its own
_SCANS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_SCANS_LOCK = threading.Lock()
_SIMULATING: dict[tuple, threading.Lock] = {}


def simulated_scan(n_det: int, n_angles: int, n_rows: int,
                   noise: float = 0.0, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
    """The scan :class:`SyntheticTomoLoader` simulates for these
    parameters: the one already alive with the same parameters on the
    same device, else a new :func:`simulate_raw_scan` (one at a time per
    parameter set).  Its arrays are shared; nothing writes to them.  The
    entry lasts while a holder of the returned dict does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (int(n_det), int(n_angles), int(n_rows), float(noise),
           int(seed), str(dev))
    with _SCANS_LOCK:
        lock = _SIMULATING.setdefault(key, threading.Lock())
    with lock:
        scan = _SCANS.get(key)
        if scan is None:
            geom = ParallelGeometry(n_angles, n_det, n_rows)
            scan = _Scan(simulate_raw_scan(phantom_stack(n_det, n_rows),
                                           geom, noise=noise, seed=seed,
                                           device=dev))
            _SCANS[key] = scan
    with _SCANS_LOCK:
        _SIMULATING.pop(key, None)
    return scan


class SyntheticTomoLoader(BaseLoader):
    """Creates a raw full-field scan (θ, y, x) from a phantom — the
    nx_tomo_loader analogue, with dark/flat fields in metadata.  The
    scan is simulated on ``device`` (:func:`simulated_scan`: loaders of
    one scan share one simulation); a ``scan`` dict of numpy arrays
    (``data``, ``dark``, ``flat``...) is taken as it is."""

    name = "synthetic_tomo_loader"
    parameters = {"n_det": 64, "n_angles": 64, "n_rows": 4, "noise": 0.0,
                  "seed": 0, "scan": None, "device": "cuda"}
    # dataset identity and where it is simulated, not pipeline
    data_params = ("seed", "scan", "device")

    def load(self) -> list[DataSet]:
        p = self.params
        scan = p["scan"]
        if scan is None:
            scan = simulated_scan(p["n_det"], p["n_angles"], p["n_rows"],
                                  p["noise"], p["seed"], p["device"])
        geom = ParallelGeometry(scan["data"].shape[0],
                                scan["data"].shape[2],
                                scan["data"].shape[1])
        data = scan["data"]
        # lazy (paper §III.F.2); the closure holds the scan, so loaders
        # set up meanwhile share it
        ds = DataSet(self.out_dataset_names[0], data.shape, data.dtype,
                     ("rotation_angle", "detector_y", "detector_x"),
                     backing=lambda: scan["data"])
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
    low-pass:  T = −ln( F⁻¹[ F[I] / (1 + τ(kx²+ky²)) ] ).

    ``tau`` (px²) is the one strength, with the frequencies k in cycles
    per pixel: τ = (δ/β)·π·λ·z / p² for the ratio δ/β, the wavelength
    λ, the propagation distance z and the pixel size p: δ/β 250 at 53
    keV, 1 m and a 1.28 µm pixel give τ ≈ 11,214 px².  ``pad_y`` and
    ``pad_x`` rows and columns are repeated from each frame's edges
    before the transform (Savu's padding) and cropped after it; the
    frequencies are those of the padded frame."""

    name = "paganin_filter"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"tau": 10.0, "pad_y": 0, "pad_x": 0}
    # tau only shapes self._denom (a constant), so it is sweepable
    tunable_params = ("tau",)

    def setup(self, in_datasets):
        (din,) = in_datasets
        dout = din.like(self.out_dataset_names[0], dtype=np.float32)
        dout.metadata = dict(din.metadata)
        py, px = self._pads()
        ky = np.fft.fftfreq(din.shape[1] + 2 * py)[:, None]
        kx = np.fft.fftfreq(din.shape[2] + 2 * px)[None, :]
        self._denom = torch.as_tensor(
            (1.0 / (1.0 + self.params["tau"] * (kx ** 2 + ky ** 2)))
            .astype(np.complex64))
        self.chunk_frames(self.pattern_name, self.frames)
        return [dout]

    def _pads(self) -> tuple[int, int]:
        py, px = int(self.params["pad_y"]), int(self.params["pad_x"])
        if py < 0 or px < 0:
            raise ValueError(f"paganin_filter: pads must be >= 0, got "
                             f"pad_y {py}, pad_x {px}")
        return py, px

    def process_frames(self, frames):
        (block,) = frames          # (m, y, x) — already −log corrected
        return self._retrieve(block, self._denom[None], self._pads())

    def process_frames_batched(self, frames, consts, counts):
        """A gang's frames, each member with its own ``tau`` (its own
        ``_denom``): one pass, each frame scaled by its member's."""
        (block,) = frames
        return self._retrieve(block, torch.stack(
            [c["_denom"] for c in consts])[member_rows(
                counts, block.shape[0], len(consts), block.device)],
            self._pads())

    def frame_bytes(self, frame_shapes):
        """A padded frame's intensity, its spectrum and the scaled
        spectrum (complex64), and the cropped result (float32)."""
        ((ny, nx),) = frame_shapes
        py, px = self._pads()
        return 3 * (ny + 2 * py) * (nx + 2 * px) * 8 + ny * nx * 4

    def span_attrs(self):
        """The step's frames, its transform's padded ``[y, x]``, the
        pads, and the float32 projections' bytes read and written."""
        frames, ny, nx = self.in_data[0].dataset.shape
        py, px = self._pads()
        return {"frames": frames, "fft_shape": [ny + 2 * py, nx + 2 * px],
                "pad": [py, px], "bytes": 2 * frames * ny * nx * 4}

    @staticmethod
    def _retrieve(block, denom, pads):
        py, px = pads
        intensity = torch.exp(-block)          # back to transmission
        if py or px:
            intensity = F.pad(intensity, (px, px, py, py), mode="replicate")
        # each padded buffer goes once the next exists: at most the three
        # complex64 frames that frame_bytes declares live at once
        spec = torch.fft.fft2(intensity.to(torch.complex64), dim=(1, 2))
        del intensity
        filt = torch.fft.ifft2(spec * denom, dim=(1, 2)).real
        del spec
        ny, nx = filt.shape[1] - 2 * py, filt.shape[2] - 2 * px
        return -torch.log(torch.clamp(filt[:, py:py + ny, px:px + nx],
                                      min=1e-6))


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
        return block - self._strength * self._stripe(block)

    def process_frames_batched(self, frames, consts, counts):
        """A gang's frames, each member with its own ``strength``: one
        pass, each frame's stripe scaled by its member's."""
        (block,) = frames
        strength = torch.tensor([c["_strength"] for c in consts],
                                dtype=block.dtype, device=block.device)
        rows = member_rows(counts, block.shape[0], len(consts), block.device)
        return block - strength[rows][:, None, None] * self._stripe(block)

    def _stripe(self, block):
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
        return col_mean - smooth


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

    def frame_bytes(self, frame_shapes):
        """A sinogram's rows padded to the FFT length (float32), their
        spectrum and its scaled copy (complex64)."""
        ((n_angles, _),) = frame_shapes
        nf = self._filt.shape[-1]
        return n_angles * (2 * (nf - 1) * 4 + 2 * nf * 8)

    def process_frames_batched(self, frames, consts, counts):
        """A gang's sinograms (member j's ``counts[j]`` after member j -
        1's), each member with its own filter (its ``cutoff``): one
        spectrum-scale launch with a filter row per member."""
        (block,) = frames
        return filter_sino(block, torch.stack([c["_filt"] for c in consts]),
                           counts=counts,
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
    (an array, or the upstream's tensor where its job left it, on the
    card for a ``CudaTransport``) or ``path`` (an ``.npy`` file) is
    given."""

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
        arr = data if isinstance(data, torch.Tensor) else np.asarray(data)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3:
            raise RuntimeError(
                f"upstream_loader: expected a (y, z, x) volume, got "
                f"shape {tuple(arr.shape)}")
        dtype = (torch.empty(0, dtype=arr.dtype).numpy().dtype
                 if isinstance(arr, torch.Tensor) else arr.dtype)
        ds = DataSet(self.out_dataset_names[0], tuple(arr.shape), dtype,
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
