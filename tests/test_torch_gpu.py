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
from repro_torch.kernels.sino_filter.ref import (filter_sino_batched_ref,
                                                 filter_sino_ref, make_filter,
                                                 scale_spectrum_batched_ref,
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


@pytest.mark.parametrize("counts,nf,offset", [
    ([3, 0, 5], 7, 0),          # members start and end at odd bins
    ([3, 3, 3], 7, 0),          # the same, equal members: no offsets
    ([4 * 1801] * 4, 4097, 0),  # a sweep of 4 at the main row length
    ([1, 2], 513, 1),           # not 16-byte aligned: the scalar pass
    ([2, 2], 513, 1),           # the same, equal members
], ids=["odd_edges", "equal_odd_edges", "sweep_of_4", "unaligned",
        "equal_unaligned"])
def test_spectrum_scale_per_member_kernel_on_card(cuda, rng, counts, nf,
                                                  offset):
    """One launch for a gang, each member's rows scaled by its own filter
    row: equal, bit for bit, to the plain version and to one launch per
    member alone."""
    rows = sum(counts)
    flat = _t(rng.normal(size=(rows * nf + offset, 2)).astype(np.float32))
    spec = torch.view_as_complex(flat.to(cuda))[offset:].view(rows, nf)
    filts = _t(rng.uniform(0, 1, size=(len(counts), nf)).astype(
        np.float32)).to(cuda)
    n = scale_spectrum_cuda.launches
    got = scale_spectrum_cuda(spec, filts, counts)
    assert scale_spectrum_cuda.launches == n + 1
    assert torch.equal(got, scale_spectrum_batched_ref(spec, filts, counts))
    lo = 0
    for j, c in enumerate(counts):
        if c:
            assert torch.equal(got[lo:lo + c], scale_spectrum_cuda(
                spec[lo:lo + c].contiguous(), filts[j]))
        lo += c
    sino = _t(rng.normal(size=(8, 5, 100)).astype(np.float32))
    sfilts = _t(np.stack([make_filter(100, k) for k in ("shepp", "hann")]))
    np.testing.assert_allclose(
        filter_sino(sino.to(cuda), sfilts, counts=[3, 5]).cpu().numpy(),
        filter_sino_batched_ref(sino, sfilts, [3, 5]).numpy(),
        rtol=1e-5, atol=1e-5)


def test_sweep_over_http_one_spectrum_scale_launch_per_gang_step(cuda):
    """A 4-value cutoff sweep through the service on the card: one gang,
    no fallback, and each gang step's span records exactly one launch of
    its kernel (three kernels, one launch each over the sweep)."""
    from repro_torch.service import (PipelineClient, PipelineService,
                                     from_spec, to_spec)
    svc = PipelineService(device=cuda, n_workers=1, batch_identical=True,
                          batch_max=4, cost_analysis=True)
    host, port = svc.serve(port=0)
    client = PipelineClient(f"http://{host}:{port}", timeout=120.0)
    chain = standard_chain(n_det=64, n_angles=48, n_rows=2, seed=1)
    cutoffs = [1.0, 0.8, 0.6, 0.4]
    try:
        reply = client.sweep(chain, {"plugin": "sinogram_filter",
                                     "param": "cutoff", "values": cutoffs})
        snap = client.wait_sweep(reply["sweep_id"], timeout=300)
        assert snap["state"] == "done", snap
        stats = client.stats()
        assert stats["gangs_run"] == 1 and stats["gang_fallbacks"] == 0
        spans = {s["name"]: s["attrs"] for s in client.trace(
            reply["job_ids"][0])["spans"] if s["name"].endswith(".process")}
        launched = {k: v for a in spans.values() for k, v in a.items()
                    if k.startswith("launches.")}
        assert launched == {"launches.correction": 1,
                            "launches.spectrum_scale": 1,
                            "launches.backprojection": 1}
        assert spans["plugin.sinogram_filter.process"][
            "launches.spectrum_scale"] == 1
        assert all(spans[f"plugin.{p}.process"]["peak_memory"] > 0
                   for p in ("dark_flat_correction", "sinogram_filter",
                             "fbp_recon"))
        stacked = client.sweep_result(reply["sweep_id"])
    finally:
        svc.stop()
    for k, cutoff in enumerate(cutoffs):
        spec = to_spec(chain)
        spec["plugins"][3]["params"]["cutoff"] = cutoff
        r = PluginRunner(from_spec(spec, device=cuda), CudaTransport(cuda))
        np.testing.assert_allclose(stacked[k],
                                   r.transport.read(r.run()["recon"]),
                                   rtol=1e-3, atol=1e-4)


def _served_on_card(cuda, **kw):
    from repro_torch.service import PipelineClient, PipelineService
    svc = PipelineService(device=cuda, **kw)
    host, port = svc.serve(port=0)
    return svc, PipelineClient(f"http://{host}:{port}", timeout=120.0)


def _process_attrs(client, jid) -> dict:
    return {s["name"]: s["attrs"] for s in client.trace(jid)["spans"]
            if s["name"].endswith(".process")}


def test_cost_analysis_measures_each_step_once_per_service(cuda):
    """Two jobs of one chain under cost analysis: the first job's steps
    run twice (the cost run and the step), the second's once, so each
    of the three kernels launches 3 times, not 4."""
    wrappers = (correct_cuda, scale_spectrum_cuda, backproject_cuda)
    svc, client = _served_on_card(cuda, n_workers=1, cost_analysis=True)
    try:
        for w in wrappers:
            w.launches = 0
        for seed in (1, 2):
            jid = client.submit(standard_chain(n_det=64, n_angles=48,
                                               n_rows=2, seed=seed))
            assert client.wait(jid, timeout=300)["state"] == "done"
        assert [w.launches for w in wrappers] == [3, 3, 3]
    finally:
        svc.stop()


def test_peak_memory_on_card_same_with_two_workers(cuda):
    """The peak memory on the process spans is each step's own: two
    workers costing two chains at once read what one worker reads."""
    def peaks(n_workers):
        svc, client = _served_on_card(cuda, n_workers=n_workers,
                                      cost_analysis=True)
        try:
            ids = [client.submit(standard_chain(n_det=nd, n_angles=nd,
                                                n_rows=4))
                   for nd in (256, 320)]
            for jid in ids:
                assert client.wait(jid, timeout=300)["state"] == "done"
            return [{n: a["peak_memory"] for n, a in
                     _process_attrs(client, jid).items()} for jid in ids]
        finally:
            svc.stop()
    one = peaks(1)
    assert peaks(2) == one
    assert one[0]["plugin.dark_flat_correction.process"] >= \
        256 * 4 * 256 * 4


def test_client_ingest_synthetic_on_card(cuda, capsys):
    """``client ingest --synthetic`` simulates on the card by default and
    feeds a served streaming job chunk by chunk from the host; the job
    ends bit for bit its batch run on the card."""
    from repro_torch.launch import pipeline_serve
    from repro_torch.service import from_spec, to_spec
    geo = ["--n-det", "64", "--n-angles", "48", "--n-rows", "2",
           "--seed", "3"]
    svc, client = _served_on_card(cuda, n_workers=1)
    try:
        url = ["client", "--url", client.base_url]
        pipeline_serve.main(url + ["submit", "--demo-chain", "--streaming",
                                   "--job-id", "scan3"] + geo)
        pipeline_serve.main(url + ["ingest", "scan3", "--synthetic",
                                   "--chunk", "16"] + geo)
        assert client.wait("scan3", timeout=300)["state"] == "done"
        got = client.result("scan3")
    finally:
        svc.stop()
    assert capsys.readouterr().out.count("fed frames") == 3
    spec = to_spec(standard_chain(n_det=64, n_angles=48, n_rows=2, seed=3))
    r = PluginRunner(from_spec(spec, device=cuda), CudaTransport(cuda))
    np.testing.assert_array_equal(got, r.transport.read(r.run()["recon"]))


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


# ------------------------------------------------ broker-mode workers
def _card_broker(**kw):
    from repro_torch.service import PipelineClient, PipelineService
    svc = PipelineService(workers_remote=True, lease_ttl=30.0, **kw)
    host, port = svc.serve(port=0)
    return svc, PipelineClient(f"http://{host}:{port}", timeout=300.0)


def _stop_workers(workers):
    for p in workers:
        if p.poll() is None:
            p.kill()
    for p in workers:
        p.wait(timeout=30)


WORKER_CHAIN = dict(n_det=128, n_angles=96, n_rows=2, seed=0)


def test_worker_process_gangs_on_the_card(cuda):
    """A worker process on the card leases a 2-variant sweep as one
    gang: each gang step's process span records one launch of its kernel
    and no fallback; each variant matches the chain run on the card in
    this process."""
    from repro_torch.service.worker import spawn_local_workers
    svc, client = _card_broker()
    workers = spawn_local_workers(client.base_url, 1, max_batch=2)
    try:
        reply = client.sweep(standard_chain(**WORKER_CHAIN),
                             [{"plugin": "sinogram_filter",
                               "param": "cutoff", "values": [0.6, 1.0]}])
        snap = client.wait_sweep(reply["sweep_id"], timeout=600)
        assert snap["state"] == "done", snap
        stacked = client.sweep_result(reply["sweep_id"])
        for k, jid in enumerate(reply["job_ids"]):
            proc = [s for s in client.trace(jid)["spans"]
                    if s.get("attrs", {}).get("phase") == "process"]
            launches = {k2: v for s in proc for k2, v in s["attrs"].items()
                        if k2.startswith("launches.")}
            assert launches == {"launches.correction": 1,
                                "launches.spectrum_scale": 1,
                                "launches.backprojection": 1}, proc
            assert {s["attrs"]["gang"] for s in proc} == {2}
            assert not any(s["name"] == "gang.fallback"
                           for s in client.trace(jid)["spans"])
            pl = standard_chain(**WORKER_CHAIN)
            for e in pl.entries:
                if e.cls.name == "sinogram_filter":
                    e.params["cutoff"] = [0.6, 1.0][k]
            r = PluginRunner(pl, CudaTransport(cuda))
            np.testing.assert_allclose(
                stacked[k], r.transport.read(r.run()["recon"]),
                rtol=1e-3, atol=1e-4)
    finally:
        _stop_workers(workers)
        svc.stop()


def test_cold_store_backed_worker_fetches_the_library(cuda, tmp_path):
    """Worker A builds the library into its empty store and publishes
    it; a cold worker B with an empty store prefetches it and runs its
    first job with ``executable.fetch``, no ``kernels.build`` and
    ``nvcc_runs == 0``, giving A's result bit for bit."""
    from repro_torch.service import to_spec
    from repro_torch.service.worker import spawn_local_workers
    svc, client = _card_broker(executables_dir=str(tmp_path / "spool"))
    spec = to_spec(standard_chain(**WORKER_CHAIN))
    workers = spawn_local_workers(client.base_url, 1, worker_ids=["A"],
                                  executables_dir=str(tmp_path / "wA"))
    try:
        ja = client.submit(spec)
        assert client.wait(ja, timeout=900)["state"] == "done"
        names_a = [s["name"] for s in client.trace(ja)["spans"]]
        assert "kernels.build" in names_a
        _stop_workers(workers)
        workers = spawn_local_workers(client.base_url, 1, worker_ids=["B"],
                                      executables_dir=str(tmp_path / "wB"))
        jb = client.submit(spec)
        assert client.wait(jb, timeout=600)["state"] == "done"
        spans = client.trace(jb)["spans"]
        names = [s["name"] for s in spans]
        assert "executable.fetch" in names and "kernels.build" not in names
        (load,) = [s for s in spans if s["name"] == "kernels.load"]
        assert load["attrs"]["nvcc_runs"] == 0
        assert client.workers()["B"]["prefetched"] >= 1
        np.testing.assert_array_equal(client.result(jb), client.result(ja))
    finally:
        _stop_workers(workers)
        svc.stop()


def test_two_workers_build_into_one_empty_directory(cuda, tmp_path):
    """Two worker processes share one empty store and make their first
    launches together: both jobs finish, and every library in the
    directory is the same one."""
    from repro_torch.service.worker import spawn_local_workers
    svc, client = _card_broker()
    store = tmp_path / "shared"
    workers = spawn_local_workers(client.base_url, 2,
                                  executables_dir=str(store))
    try:
        ids = [client.submit(standard_chain(**{**WORKER_CHAIN, "seed": s}))
               for s in range(2)]
        snaps = [client.wait(j, timeout=900) for j in ids]
        assert [s["state"] for s in snaps] == ["done", "done"], snaps
        libs = sorted(store.glob("*.so"))
        assert len(list(store.glob("libtomo_kernels-*.so"))) == 1
        assert len({p.read_bytes() for p in libs}) == 1
        for jid in ids:
            assert any(s["name"] == "kernels.load"
                       for s in client.trace(jid)["spans"])
    finally:
        _stop_workers(workers)
        svc.stop()
