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

from repro_torch.configs import get_config, smoke_batch
from repro_torch.core import CudaTransport, DataSet, PluginRunner
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
from repro_torch.obs import Trace
from repro_torch.training import greedy_generate
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


#: a volume's shape for the reads below: 3 x 320 x 320 float32,
#: 1,228,800 B, a 2 MiB page-locked block
READ_SHAPE = (3, 320, 320)


def _read_on_card(cuda, seed):
    """A fresh card-resident dataset of READ_SHAPE read through a
    ``CudaTransport``: (array, the tensor's own host copy, the span)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    t = torch.randn(READ_SHAPE, device=cuda, generator=g)
    ds = DataSet("recon", READ_SHAPE, np.float32, ("z", "y", "x"),
                 backing=t, trace=Trace())
    vol = CudaTransport(cuda).read(ds)
    (span,) = [s for s in ds.trace.spans() if s.name == "transport.to_host"]
    return vol, t.cpu().numpy(), span


def test_read_off_card_is_a_page_locked_copy_bit_for_bit(cuda):
    vol, want, span = _read_on_card(cuda, 0)
    assert vol.dtype == want.dtype and vol.shape == want.shape
    assert vol.tobytes() == want.tobytes()
    assert vol.flags.c_contiguous and vol.flags.writeable
    assert span.attrs["pinned"] is True
    assert span.attrs["bytes"] == vol.nbytes == 1_228_800
    assert span.attrs["device"] == f"cuda:{torch.cuda.current_device()}"


def test_a_dropped_results_block_serves_the_next_read(cuda):
    vol, _, first = _read_on_card(cuda, 1)
    assert first.attrs["pinned"] is True
    del vol
    n = torch.cuda.host_memory_stats()["num_host_alloc"]
    vol, want, again = _read_on_card(cuda, 2)
    assert again.attrs["pinned"] is True and again.attrs["reused"] is True
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == n
    assert vol.tobytes() == want.tobytes()


def test_a_held_result_is_never_handed_out_again(cuda):
    held, want, _ = _read_on_card(cuda, 3)
    for seed in (4, 5, 6):
        vol, other, span = _read_on_card(cuda, seed)
        assert span.attrs["pinned"] is True
        assert vol.ctypes.data != held.ctypes.data
        assert vol.tobytes() == other.tobytes() != want.tobytes()
        del vol
    assert held.tobytes() == want.tobytes()


def test_read_off_card_falls_back_to_pageable_when_the_cap_refuses(
        cuda, monkeypatch):
    from repro_torch.core import transport
    monkeypatch.setattr(transport, "pin_fits", lambda *a: False)
    n = torch.cuda.host_memory_stats()["num_host_alloc"]
    vol, want, span = _read_on_card(cuda, 7)
    assert span.attrs["pinned"] is False and span.attrs["reused"] is False
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == n
    assert vol.tobytes() == want.tobytes()
    assert vol.flags.c_contiguous and vol.flags.writeable


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


def _spectrum_kernels(run) -> list[str]:
    """The names of the spectrum-scale kernels that ``run()`` launched
    (their template argument is the index type)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if "scale_spectrum" in e.key and "kernel" in e.key]


def test_spectrum_scale_indexes_in_32_bits_below_2_31_bins(cuda, rng):
    """Today's shapes (a 16-row band: 1801 x 16 x 4097 bins) keep the
    32-bit kernel."""
    spec = torch.randn(1801 * 16, 4097, dtype=torch.complex64, device=cuda)
    filt = torch.rand(4097, device=cuda)
    names = _spectrum_kernels(lambda: scale_spectrum_cuda(spec, filt))
    assert names and all("<unsigned int>" in n for n in names), names


def test_spectrum_scale_beyond_2_31_bins_on_card(cuda):
    """2 rows of 2**30 + 1 bins (2**31 + 2 bins, 17.2 GB a copy): the
    64-bit kernel, equal bit for bit to ``spec * filt``; a float4 at the
    row edge and the odd tail included."""
    nf = 2**30 + 1
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 60e9:
        pytest.skip(f"needs 60 GB free on the card, has {free / 1e9:.1f}")
    gen = torch.Generator(device=cuda).manual_seed(7)
    spec = torch.randn(2, nf, dtype=torch.complex64, device=cuda,
                       generator=gen)
    filt = torch.rand(nf, device=cuda, generator=gen)
    got = []
    names = _spectrum_kernels(lambda: got.append(
        scale_spectrum_cuda(spec, filt)))
    assert names and all("<unsigned long long>" in n for n in names), names
    (got,) = got
    assert torch.equal(got, scale_spectrum_ref(spec, filt))


def test_four_slots_on_one_card_equal_the_one_card_chain(cuda):
    """ShardedTransport over ("cuda:0",) * 4: the reconstruction equals
    the one-card run, and every kernel launches once per slot."""
    from repro_torch.core import ShardedTransport
    scan = simulate_raw_scan(phantom_stack(64, 4),
                             ParallelGeometry(96, 64, 4), device=cuda)
    one = PluginRunner(_scan_chain(scan, 64, 96, 4), CudaTransport(cuda))
    want = one.transport.read(one.run()["recon"])
    before = (correct_cuda.launches, scale_spectrum_cuda.launches,
              backproject_cuda.launches)
    tr = ShardedTransport(("cuda:0",) * 4)
    r = PluginRunner(_scan_chain(scan, 64, 96, 4), tr)
    got = tr.read(r.run()["recon"])
    assert (correct_cuda.launches, scale_spectrum_cuda.launches,
            backproject_cuda.launches) == tuple(b + 4 for b in before)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert len(r.datasets["recon"].backing.shards) == 4
    assert tr.stats()["alltoall_bytes"] == 96 * 4 * 64 * 4 * 3 // 4


def test_frame_budget_on_card(cuda):
    """A stack that needs at most a sixteenth of the card runs whole
    without asking the CUDA driver; a larger one gets a quarter of what
    is free."""
    from repro_torch.core.transport import frame_budget
    total = torch.cuda.get_device_properties(cuda).total_memory
    assert frame_budget(cuda, total // 16) is None
    budget = frame_budget(cuda, total)
    assert 0 < budget <= total // 4


def test_uneven_split_over_four_slots_on_one_card(cuda):
    """97 angles and 6 rows over ("cuda:0",) * 4: projections 25/24/24/24,
    sinograms 2/2/1/1, each kernel once a slot; the volume equals the
    one-card run."""
    from repro_torch.core import ShardedTransport
    scan = simulate_raw_scan(phantom_stack(64, 6),
                             ParallelGeometry(97, 64, 6), device=cuda)
    one = PluginRunner(_scan_chain(scan, 64, 97, 6), CudaTransport(cuda))
    want = one.transport.read(one.run()["recon"])
    tr = ShardedTransport(("cuda:0",) * 4)
    r = PluginRunner(_scan_chain(scan, 64, 97, 6), tr)
    r.prepare()
    r.step()
    assert [t.shape[0] for t in r.datasets["tomo"].backing.shards] == \
        [25, 24, 24, 24]
    while r.step():
        pass
    r.finalise()
    recon = r.datasets["recon"].backing
    assert [t.shape[0] for t in recon.shards] == [2, 2, 1, 1]
    np.testing.assert_allclose(tr.read(r.datasets["recon"]), want,
                               rtol=1e-3, atol=1e-4)


def test_each_kernel_launches_on_the_second_card(cuda, rng):
    """The device guard: with cuda:0 current, each kernel launched on a
    tensor on cuda:1 runs there and equals its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: this host has one, so a "
                    "launch on a card other than the current one cannot "
                    "be tried here")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    raw = _t(rng.integers(50, 40000, size=(9, 16, 64)).astype(np.uint16))
    dark = _t(rng.integers(80, 120, size=(16, 64)).astype(np.float32))
    flat = _t(rng.integers(30000, 42000, size=(16, 64)).astype(np.float32))
    got = correct_cuda(raw.to(dev), dark.to(dev), flat.to(dev))
    assert got.device == dev
    np.testing.assert_allclose(got.cpu().numpy(), correct_ref(
        raw, dark[None], flat[None]).numpy(), rtol=1e-6, atol=1e-6)
    spec = torch.randn((33, 129), dtype=torch.complex64, device=dev)
    filt = torch.rand(129, device=dev)
    torch.testing.assert_close(scale_spectrum_cuda(spec, filt),
                               scale_spectrum_ref(spec, filt), rtol=1e-5,
                               atol=1e-5)
    sino = torch.randn((3, 48, 64), device=dev)
    angles = torch.from_numpy(ParallelGeometry(48, 64, 1).angles.astype(
        np.float32))
    torch.testing.assert_close(
        backproject(sino, angles, 64).cpu(),
        backproject_ref(sino.cpu(), angles, 64), rtol=2e-4, atol=2e-5)
    q, k, v = (torch.randn((1, 4, 128, 64), device=dev) for _ in range(3))
    torch.testing.assert_close(flash_attention_cuda(q, k, v),
                               mha_ref(q, k, v), rtol=2e-5, atol=2e-5)
    assert torch.cuda.current_device() == 0


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


# (B, Hq, Hkv, Sq, Sk, D): Whisper's cross-attention (4 decoder tokens
# against 1500 encoder frames, which no 64-key tile divides), more
# queries than keys, grouped heads and a single key
FLASH_CROSS_CASES = [(4, 12, 12, 4, 1500, 64), (2, 4, 2, 100, 37, 32),
                     (1, 8, 2, 65, 130, 128), (2, 2, 1, 3, 1, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", FLASH_CROSS_CASES)
def test_flash_attention_kernel_own_key_length_on_card(cuda, rng, B, Hq, Hkv,
                                                       Sq, Sk, D, dtype):
    """Non-causal attention over Sk keys of its own, as Whisper's
    cross-attention needs, against ``mha_ref`` (fp32 2e-5; bf16 rtol
    1e-2, atol 1e-3) and, in bf16, against its own tiled arithmetic."""
    dt = getattr(torch, dtype)
    q = _t(rng.normal(size=(B, Hq, Sq, D))).to(cuda, dt)
    k, v = (_t(rng.normal(size=(B, Hkv, Sk, D))).to(cuda, dt)
            for _ in range(2))
    n = flash_attention_cuda.launches
    got = attention(q, k, v, causal=False, use_pallas=True)
    assert flash_attention_cuda.launches == n + 1
    assert got.shape == q.shape and got.dtype == dt
    got = got.float().cpu().numpy()
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-3))
    np.testing.assert_allclose(
        got, mha_ref(q, k, v, causal=False).float().cpu().numpy(), **tol)
    if dtype == "bfloat16":
        np.testing.assert_allclose(
            got, mha_tiled_ref(q, k, v, causal=False).float().cpu().numpy(),
            rtol=2.0 ** -7, atol=1e-5)


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


def test_flash_attention_kernel_causal_needs_one_length_on_card(cuda):
    """Sq != Sk is taken when non-causal and refused when causal."""
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    kv = torch.zeros((1, 2, 24, 32), device=cuda)
    assert flash_attention_cuda(q, kv, kv, causal=False).shape == q.shape
    with pytest.raises(ValueError, match="causal attention takes one length"):
        flash_attention_cuda(q, kv, kv, causal=True)


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


# each family's smoke configuration and its flash launches per prefill:
# one per attention layer, the shared block's applications (Zamba2), the
# encoder's, the decoder's self- and cross-attention layers (Whisper)
FAMILY_LAUNCHES = {"qwen3-moe-235b-a22b": 3, "llama4-maverick-400b-a17b": 4,
                   "llava-next-34b": 2, "zamba2-1.2b": 2, "xlstm-1.3b": 0,
                   "whisper-small": 6}


@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_family_on_card_matches_cpu(cuda, arch):
    """A family's smoke model (fp32) with the kernel on the card against
    the plain versions on the CPU, on the same weights: prefill logits
    within 2e-4, greedy tokens identical."""
    import copy
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, smoke=True), use_flash=True)
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card_params = copy.deepcopy(params).to(cuda)     # Module.to moves
    batch = smoke_batch(cfg, batch=2, seq=16, seed=3)
    batch.pop("labels")
    want, _ = cpu_model.prefill(params, batch, 32)
    n = flash_attention_cuda.launches
    got, _ = card_model.prefill(card_params, batch, 32)
    assert flash_attention_cuda.launches == n + FAMILY_LAUNCHES[arch]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(
        greedy_generate(card_model, card_params, batch, max_new=6,
                        max_len=32),
        greedy_generate(cpu_model, params, batch, max_new=6, max_len=32))


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


# ------------------------------------------------------------ training
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-235b-a22b",
                                  "xlstm-1.3b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Two train steps of a smoke model (fp32) on the card against the
    same steps on the CPU from the same weights: loss and grad_norm
    within rtol 1e-4; each updated leaf within rtol 1e-4 and atol 1e-2 ·
    lr per step where the first gradient is >= 1e-4 of its leaf's max or
    is 0 on both sides (weight decay alone), and within 0.25 · lr per
    step elsewhere (see tests/test_torch_training.py)."""
    import copy
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.training import init_training, make_train_step
    cfg = get_config(arch, smoke=True)
    cpu_model = build_model(cfg, "cpu", training=True)
    card_model = build_model(cfg, cuda, training=True)
    params, opt = init_training(cpu_model, torch.Generator().manual_seed(0))
    card_params = copy.deepcopy(params).to(cuda)
    card_opt = init_opt_state(card_params)
    batch = smoke_batch(cfg, batch=2, seq=16, seed=3)
    grads = []
    for model, ps in ((cpu_model, params), (card_model, card_params)):
        model.loss(ps, batch).backward()
        grads.append({n: p.grad.abs().cpu() for n, p in ps.named_parameters()})
        for p in ps.parameters():
            p.grad = None
    steps = 2
    for _ in range(steps):
        params, opt, m = make_train_step(cpu_model, AdamWConfig(**TRAIN_OPT))(
            params, opt, batch)
        card_params, card_opt, cm = make_train_step(
            card_model, AdamWConfig(**TRAIN_OPT))(card_params, card_opt,
                                                  batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(cm[k]), float(m[k]), rtol=1e-4)
    lr = TRAIN_OPT["lr"]
    for (n, a), b in zip(params.named_parameters(),
                         card_params.parameters()):
        a, b = a.detach().numpy(), b.detach().cpu().numpy()
        g, cg = grads[0][n], grads[1][n]
        held = ((g >= 1e-4 * g.max()) | ((g == 0) & (cg == 0))).numpy()
        np.testing.assert_allclose(b[held], a[held], rtol=1e-4,
                                   atol=1e-2 * lr * steps, err_msg=n)
        assert np.abs(a - b).max() <= 0.25 * lr * steps, n


def test_flash_kernel_raises_under_autograd_on_card(cuda):
    q = torch.randn((1, 2, 64, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 2, 64, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        attention(q, kv, kv, use_pallas=True)
    with torch.no_grad():
        n = flash_attention_cuda.launches
        assert attention(q, kv, kv, use_pallas=True).shape == q.shape
        assert flash_attention_cuda.launches == n + 1


def test_remat_saves_fewer_bytes_on_card(cuda):
    """What a forward leaves allocated for its backward: remat 'dots'
    (products without batch dims saved) holds less than remat off, and
    'nothing' (layer inputs only) less than 'dots'."""
    import dataclasses
    from repro_torch.training import init_training
    base = dataclasses.replace(get_config("granite-8b", smoke=True),
                               d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=64, d_ff=1024)
    batch = smoke_batch(base, batch=2, seq=256, seed=3)
    held = {}
    for name, over in [("off", dict(remat=False)),
                       ("dots", dict(remat=True, remat_policy="dots")),
                       ("nothing", dict(remat=True, remat_policy="nothing"))]:
        cfg = dataclasses.replace(base, **over)
        model = build_model(cfg, cuda, training=True)
        params, _ = init_training(model, torch.Generator(cuda).manual_seed(0))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = model.loss(params, batch)
        torch.cuda.synchronize()
        held[name] = torch.cuda.memory_allocated() - before
        loss.backward()
        del loss, params
    assert held["nothing"] < held["dots"] < held["off"], held
