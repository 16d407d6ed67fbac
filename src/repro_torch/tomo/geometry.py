"""Parallel-beam tomography geometry (paper §II.B, Fig 2/3).

Full-field geometry: a parallel x-ray beam traverses the sample; the
detector records a 2-D projection at each rotation angle θ ∈ [0, π).
Raw data layout follows the paper's NeXus convention: (θ, y, x) with x
the detector column (sinogram detector axis) and y the detector row
(slice axis).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParallelGeometry:
    n_angles: int
    n_det: int                 # detector columns (x)
    n_rows: int = 1            # detector rows (y) = number of slices
    angle_start: float = 0.0
    angle_end: float = math.pi  # [0, π) single scan
    det_spacing: float = 1.0
    centre_offset: float = 0.0  # rotation-centre mis-set, in pixels

    @property
    def angles(self) -> np.ndarray:
        return np.linspace(self.angle_start, self.angle_end, self.n_angles,
                           endpoint=False, dtype=np.float64)

    @property
    def centre(self) -> float:
        return (self.n_det - 1) / 2.0 + self.centre_offset

    def image_shape(self, n: int | None = None) -> tuple[int, int]:
        n = n or self.n_det
        return (n, n)

    def scaled(self, factor: int) -> "ParallelGeometry":
        return ParallelGeometry(self.n_angles // factor,
                                self.n_det // factor,
                                max(1, self.n_rows // factor),
                                self.angle_start, self.angle_end,
                                self.det_spacing * factor,
                                self.centre_offset / factor)
