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

from repro_torch.configs import get_config
from repro_torch.core import CudaTransport, PluginRunner
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import mha_ref, mha_tiled_ref
from repro_torch.kernels.backproject.kernel import backproject_cuda
from repro_torch.kernels.backproject.ops import backproject
from repro_torch.kernels.backproject.ref import (backproject_ref,
                                                 backproject_tiled_ref)
from repro_torch.kernels.correction.kernel import correct_cuda
from repro_torch.kernels.correction.ops import correct
from repro_torch.kernels.correction.ref import (correct_batched_ref,
                                                correct_ref)
from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
from repro_torch.kernels.sino_filter.ops import filter_sino
from repro_torch.kernels.sino_filter.ref import (filter_sino_ref, make_filter,
                                                 scale_spectrum_ref)
from repro_torch.models import build_model
from repro_torch.tomo import (ParallelGeometry, phantom_stack,
                              simulate_raw_scan, standard_chain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' fp32 products in full fp32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (F, Y, X, offset): frame counts no run of 4 divides, a plane no 8
# pixels divide, raw views 1 and 3 elements into their allocation (not
# 16-byte aligned)
CORRECTION_CASES = [(5, 33, 64, 0), (13, 16, 64, 0), (9, 5, 7, 0),
                    (4, 16, 64, 1), (17, 33, 64, 3)]


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("F,Y,X,offset", CORRECTION_CASES,
                         ids=["aligned", "ragged_frames", "ragged_plane",
                              "offset_1", "offset_3"])
def test_correction_kernel_on_card(cuda, rng, dtype, F, Y, X, offset):
    """Both paths of the kernel (16-byte and scalar) with dead pixels
    (flat == dark) and raw below dark, at the reference's 1e-6."""
    raw = _t(rng.integers(0, 40000, size=F * Y * X + offset).astype(dtype))
    raw = raw.to(cuda)[offset:].view(F, Y, X)
    dark = _t(rng.integers(80, 120, size=(Y, X)).astype(np.float32))
    flat = _t(rng.integers(30000, 42000, size=(Y, X)).astype(np.float32))
    flat.view(-1)[::5] = dark.view(-1)[::5]
    n = correct_cuda.launches
    got = correct(raw, dark.to(cuda), flat.to(cuda))
    assert correct_cuda.launches == n + 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, correct_ref(raw.cpu(), dark, flat).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("counts,Y,X", [((5, 7, 1801), 16, 64),
                                        ((3, 0, 6), 5, 7)],
                         ids=["ragged_vector", "scalar_with_empty"])
def test_correction_batched_kernel_on_card(cuda, rng, dtype, counts, Y, X):
    """A gang in one launch: members' frame counts no run of 4 divides,
    each member with its own dark/flat; equal bit for bit to correcting
    each member alone."""
    raw = _t(rng.integers(0, 40000, size=(sum(counts), Y, X)).astype(dtype))
    dark = _t(rng.integers(80, 120, size=(len(counts), Y, X))
              .astype(np.float32))
    flat = _t(rng.integers(30000, 42000, size=(len(counts), Y, X))
              .astype(np.float32))
    n = correct_cuda.launches
    got = correct(raw.to(cuda), dark.to(cuda), flat.to(cuda),
                  counts=list(counts))
    assert correct_cuda.launches == n + 1
    np.testing.assert_allclose(
        got.cpu().numpy(),
        correct_batched_ref(raw, dark, flat, list(counts)).numpy(),
        rtol=1e-6, atol=1e-6)
    lo = 0
    for j, c in enumerate(counts):
        alone = correct_cuda(raw[lo:lo + c].to(cuda),
                             dark[j].to(cuda), flat[j].to(cuda))
        assert torch.equal(got[lo:lo + c], alone)
        lo += c


def test_first_launches_from_two_threads_build_once(cuda, rng, tmp_path,
                                                     monkeypatch):
    """Two threads make their first launch together against an empty
    build directory: the library is built and loaded once, and both
    outputs are right."""
    import threading

    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_FUNCS", {})
    builds = []
    real_build = build.build

    def counted():
        builds.append(threading.current_thread().name)
        return real_build()

    monkeypatch.setattr(build, "build", counted)
    raws = [_t(rng.integers(0, 40000, size=(6, 8, 64)).astype(np.uint16))
            for _ in range(2)]
    dark = _t(rng.integers(80, 120, size=(8, 64)).astype(np.float32))
    flat = _t(rng.integers(30000, 42000, size=(8, 64)).astype(np.float32))
    outs, errors = [None, None], []
    barrier = threading.Barrier(2)

    def launch(i):
        try:
            barrier.wait()
            outs[i] = correct_cuda(raws[i].to(cuda), dark.to(cuda),
                                   flat.to(cuda)).cpu()
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert errors == [] and len(builds) == 1
    assert len(list((tmp_path / "kernels").glob("libtomo_kernels-*.so"))) == 1
    for raw, out in zip(raws, outs):
        np.testing.assert_allclose(out.numpy(),
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


@pytest.mark.parametrize("rows,nf,offset", [
    (3, 7, 0),          # 21 bins: odd, a scalar tail after the float4s
    (31, 4097, 0),      # the main path's row length: float4s across rows
    (64, 4097, 0),      # an even bin count
    (5, 513, 1),        # one bin into an allocation: not 16-byte aligned
], ids=["odd", "nf4097_odd", "nf4097_even", "unaligned"])
def test_spectrum_scale_kernel_on_card(cuda, rng, rows, nf, offset):
    flat = _t(rng.normal(size=(rows * nf + offset, 2)).astype(np.float32))
    spec = torch.view_as_complex(flat.to(cuda))[offset:].view(rows, nf)
    filt = _t(rng.uniform(0, 1, size=nf).astype(np.float32)).to(cuda)
    n = scale_spectrum_cuda.launches
    got = scale_spectrum_cuda(spec, filt)
    assert scale_spectrum_cuda.launches == n + 1
    np.testing.assert_allclose(
        torch.view_as_real(got).cpu().numpy(),
        torch.view_as_real(scale_spectrum_ref(spec, filt)).cpu().numpy(),
        rtol=1e-5, atol=1e-5)


# (S, A, D, N, centre): slice counts for which the entry point picks
# each group size (1, 3, 5, 9, 16 and 17 take groups of 1, 4, 2, 2, 8 and
# 4), most of them ragged, N != D, centre offsets, angle counts
# that 16-angle chunks do not divide, tiles whose rays miss the detector
BP_CASES = [(3, 17, 30, 27, 15.25), (1, 33, 64, 80, None),
            (5, 50, 96, 64, 40.0), (9, 16, 40, 40, None),
            (17, 45, 64, 48, 30.5), (16, 181, 256, 256, None)]


@pytest.mark.parametrize("S,A,D,N,centre", BP_CASES)
def test_backproject_kernel_on_card(cuda, rng, S, A, D, N, centre):
    """The kernel against the plain version at the reference's
    tolerance, and against its own arithmetic (``backproject_tiled_ref``
    on the card, the same cos/sin): there the two differ only where the
    float64 emulation of an FMA rounds twice."""
    sino = _t(rng.normal(size=(S, A, D)).astype(np.float32))
    angles = torch.linspace(0, np.pi, A + 1)[:-1]
    n = backproject_cuda.launches
    got = backproject(sino.to(cuda), angles, N, centre=centre)
    assert backproject_cuda.launches == n + 1
    assert got.shape == (S, N, N)
    np.testing.assert_allclose(
        got.cpu().numpy(), backproject_ref(sino, angles, N, centre).numpy(),
        rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        got.cpu().numpy(),
        backproject_tiled_ref(sino.to(cuda), angles.to(cuda), N,
                              centre).cpu().numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("S,A,D,N,centre", [BP_CASES[0], BP_CASES[2]])
def test_backproject_group_sizes_on_card(cuda, rng, group, S, A, D, N,
                                         centre):
    """Each group size of slices a block may own, launched through
    ``backproject_group``, gives the entry point's output bit for bit
    (every slice's sum is the same arithmetic) on ragged shapes."""
    import ctypes

    from repro_torch.kernels import build
    sino = _t(rng.normal(size=(S, A, D)).astype(np.float32)).to(cuda)
    angles = torch.linspace(0, np.pi, A + 1)[:-1].to(cuda)
    cos_t, sin_t = torch.cos(angles), torch.sin(angles)
    want = backproject_cuda(sino, cos_t, sin_t, N, centre)
    got = torch.full_like(want, float("nan"))
    fn = build.function("backproject_group", (ctypes.c_void_p,) * 4 + (
        ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p))
    build.check(fn(build.ptr(sino), build.ptr(cos_t), build.ptr(sin_t),
                   build.ptr(got), S, A, D, N,
                   (D - 1) / 2.0 if centre is None else centre,
                   float(np.float32(np.pi / A)), group,
                   build.stream(sino.device)),
                "backproject_group")
    assert torch.equal(got, want)


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


def _scan_chain(scan, n, angles, rows):
    chain = standard_chain(n, angles, rows)
    chain.entries[0].params["scan"] = scan
    return chain


def test_streamed_chain_on_card_equals_batch_bit_for_bit(cuda):
    """Slabs of random size through feed/pump on the card: one
    correction launch per slab, the batch run's reconstruction bit for
    bit, and a preview on the card mid-stream."""
    scan = simulate_raw_scan(phantom_stack(64, 2),
                             ParallelGeometry(70, 64, 2), device=cuda)
    batch = PluginRunner(_scan_chain(scan, 64, 70, 2), CudaTransport(cuda))
    want = batch.run()["recon"].backing
    runner = PluginRunner(_scan_chain(scan, 64, 70, 2), CudaTransport(cuda))
    runner.enable_streaming()
    assert runner.datasets["tomo"].backing.device.type == "cuda"
    rng = np.random.default_rng(0)
    n = correct_cuda.launches
    fed, slabs = 0, 0
    while fed < 70:
        k = int(rng.integers(1, 13))
        fed = runner.feed(scan["data"][fed:fed + k], fed)
        runner.pump()
        slabs += 1
        if fed >= 35 and fed - k < 35:
            arr, cut = runner.preview()
            assert cut == fed and arr.shape == (2, 64, 64)
            assert np.isfinite(arr).all()
    assert correct_cuda.launches == n + slabs
    runner.finalise()
    assert torch.equal(runner.datasets["recon"].backing, want)


def test_gang_on_card_launches_each_kernel_once(cuda):
    """Three scans gang-batched: one launch of each kernel for the gang,
    each member within the chain bound of its serial run."""
    from repro_torch.service import JobQueue, PipelineScheduler
    scans = [simulate_raw_scan(phantom_stack(64, 2),
                               ParallelGeometry(48, 64, 2), seed=s,
                               device=cuda) for s in range(3)]
    q = JobQueue()
    sched = PipelineScheduler(q, n_workers=1, batch_identical=True,
                              transport_factory=lambda j: CudaTransport(cuda))
    jobs = [q.submit(_scan_chain(s, 64, 48, 2)) for s in scans]
    before = (correct_cuda.launches, scale_spectrum_cuda.launches,
              backproject_cuda.launches)
    sched.start()
    try:
        assert sched.drain(timeout=120)
    finally:
        sched.shutdown()
    assert sched.gangs_run == 1
    assert (correct_cuda.launches, scale_spectrum_cuda.launches,
            backproject_cuda.launches) == tuple(b + 1 for b in before)
    for s, job in zip(scans, jobs):
        serial = PluginRunner(_scan_chain(s, 64, 48, 2), CudaTransport(cuda))
        want = serial.transport.read(serial.run()["recon"])
        got = job.runner.transport.read(job.runner.datasets["recon"])
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# (B, Hq, Hkv, S, D): the reference's sweep, then group sizes 4 and 48
# (granite-34b's MQA) at D 128 and ragged lengths no tile divides
FLASH_CASES = [(2, 4, 2, 64, 16), (1, 8, 1, 128, 32), (2, 4, 4, 32, 64),
               (1, 6, 2, 96, 16), (1, 32, 8, 1000, 128), (1, 48, 1, 200, 128),
               (2, 4, 2, 77, 64), (1, 2, 1, 1, 32)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", FLASH_CASES)
def test_flash_attention_kernel_on_card(cuda, rng, B, Hq, Hkv, S, D, causal):
    q = _t(rng.normal(size=(B, Hq, S, D)).astype(np.float32)).to(cuda)
    k = _t(rng.normal(size=(B, Hkv, S, D)).astype(np.float32)).to(cuda)
    v = _t(rng.normal(size=(B, Hkv, S, D)).astype(np.float32)).to(cuda)
    n = flash_attention_cuda.launches
    got = attention(q, k, v, causal=causal, use_pallas=True)
    assert flash_attention_cuda.launches == n + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               mha_ref(q, k, v, causal=causal).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", FLASH_CASES)
def test_flash_attention_tensor_core_kernel_on_card(cuda, rng, B, Hq, Hkv, S,
                                                    D, causal):
    """The bf16 tensor-core kernel against ``mha_ref`` at the card
    check's tolerance, and against ``mha_tiled_ref``, which repeats its
    arithmetic: there the two differ in fp32 only by exp's last bits, the
    order of the sums and the P split's 2**-18 residual (~1e-6 of an
    output), which can put them on two sides of one bf16 rounding of the
    output (at most 2**-7 of its value)."""
    q, k, v = (_t(rng.normal(size=(B, h, S, D))).to(cuda, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    n = flash_attention_cuda.launches
    got = attention(q, k, v, causal=causal, use_pallas=True)
    assert flash_attention_cuda.launches == n + 1
    assert got.dtype == torch.bfloat16
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(
        got, mha_ref(q, k, v, causal=causal).float().cpu().numpy(),
        rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(
        got, mha_tiled_ref(q, k, v, causal=causal).float().cpu().numpy(),
        rtol=2.0 ** -7, atol=1e-5)


def test_flash_attention_kernel_bf16_on_card(cuda, rng):
    """Both sides compute in fp32 from the same bf16 inputs and differ by
    the output's rounding (at most 2**-7 of a value) and the order of the
    sums; a missing or misread key tile moves outputs of about 0.1 (S
    300) by far more than the atol."""
    q, k, v = (_t(rng.normal(size=(1, 4, 300, 128))).to(cuda, torch.bfloat16)
               for _ in range(3))
    got = flash_attention_cuda(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               mha_ref(q, k, v).float().cpu().numpy(),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 64, 32), (1, 2, 48, 32)), "one length"),
    (((1, 2, 64, 48), (1, 2, 64, 48)), "head dim"),
    (((1, 3, 64, 32), (1, 2, 64, 32)), "multiple"),
], ids=["sq_ne_sk", "head_dim", "groups"])
def test_flash_attention_kernel_refuses_on_card(cuda, shapes, match):
    q = torch.zeros(shapes[0], device=cuda)
    kv = torch.zeros(shapes[1], device=cuda)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(q, kv, kv)


def test_lm_prefill_with_kernel_matches_cpu(cuda):
    """A smoke LM prefilled through the kernel on the card against the
    plain version on the CPU, with the same weights."""
    import dataclasses
    cfg = dataclasses.replace(get_config("granite-8b", smoke=True),
                              use_flash=True)
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40))
    want, _ = cpu_model.prefill(params, {"tokens": toks}, 48)
    n = flash_attention_cuda.launches
    got, _ = card_model.prefill(params.to(cuda), {"tokens": toks}, 48)
    assert flash_attention_cuda.launches == n + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
