"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, and the chain on the card against the chain on the CPU.

Every test here carries the ``gpu`` marker and skips without a CUDA
device.  The file imports neither jax nor the JAX package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CudaTransport, PluginRunner
from repro_torch.kernels.backproject.kernel import backproject_cuda
from repro_torch.kernels.backproject.ops import backproject
from repro_torch.kernels.backproject.ref import backproject_ref
from repro_torch.kernels.correction.kernel import correct_cuda
from repro_torch.kernels.correction.ops import correct
from repro_torch.kernels.correction.ref import correct_ref
from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
from repro_torch.kernels.sino_filter.ops import filter_sino
from repro_torch.kernels.sino_filter.ref import filter_sino_ref, make_filter
from repro_torch.tomo import (ParallelGeometry, phantom_stack,
                              simulate_raw_scan, standard_chain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_correction_kernel_on_card(cuda, rng):
    for dtype in (np.uint16, np.float32):
        raw = _t(rng.integers(50, 40000, size=(5, 33, 64)).astype(dtype))
        dark = _t(rng.integers(80, 120, size=(33, 64)).astype(np.float32))
        flat = _t(rng.integers(30000, 42000, size=(33, 64))
                  .astype(np.float32))
        n = correct_cuda.launches
        got = correct(raw.to(cuda), dark.to(cuda), flat.to(cuda))
        assert correct_cuda.launches == n + 1
        np.testing.assert_allclose(got.cpu().numpy(),
                                   correct_ref(raw, dark, flat).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_sino_filter_kernel_on_card(cuda, rng):
    sino = _t(rng.normal(size=(3, 100)).astype(np.float32))
    filt = _t(make_filter(100, "hann"))
    n = scale_spectrum_cuda.launches
    got = filter_sino(sino.to(cuda), filt)
    assert scale_spectrum_cuda.launches == n + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               filter_sino_ref(sino, filt).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_backproject_kernel_on_card(cuda, rng):
    """Ragged sizes (no tile divides 27, 17 angles) and an off-centre
    rotation axis."""
    sino = _t(rng.normal(size=(3, 17, 30)).astype(np.float32))
    angles = torch.linspace(0, np.pi, 18)[:-1]
    n = backproject_cuda.launches
    got = backproject(sino.to(cuda), angles, 27, centre=15.25)
    assert backproject_cuda.launches == n + 1
    np.testing.assert_allclose(
        got.cpu().numpy(),
        backproject_ref(sino, angles, 27, centre=15.25).numpy(),
        rtol=2e-4, atol=2e-5)


def test_chain_on_card_matches_cpu(cuda):
    scan = simulate_raw_scan(phantom_stack(64, 2),
                             ParallelGeometry(64, 64, 2), device=cuda)
    recons = []
    for device in ("cuda", "cpu"):
        chain = standard_chain(64, 64, 2, device=device)
        chain.entries[0].params["scan"] = scan
        runner = PluginRunner(chain, CudaTransport(device))
        recons.append(runner.transport.read(runner.run()["recon"]))
    np.testing.assert_allclose(recons[0], recons[1], rtol=1e-3, atol=1e-4)
