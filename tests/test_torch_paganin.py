"""The Paganin filter with Savu's edge padding: on the CPU equal to a
float64 NumPy retrieval and to the benchmark's plain reference (its
retrieval, and the whole phase-contrast chain through the runner), the
same in frame blocks as in one call, a gang's members with their own
``tau`` equal to one-by-one runs; its ``process`` span says what the
roofline reader counts; the phase-contrast cell's files are found by
name and a tiny copy of the cell runs end to end.  One ``gpu`` test
runs the step at the cell's size on the card.

The file imports neither jax nor the JAX package (the unpadded filter's
parity with it is in ``test_torch_tomo.py``)."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import CudaTransport, DataSet, PluginRunner
from repro_torch.core import transport as T
from repro_torch.core.plugin import PluginData
from repro_torch.tomo import plugins as TP
from tomobench import bench, program, scans, yardsticks
from tomobench.drivers.closed_phase import ClosedPhase
from tomobench.drivers.closed_runner import ClosedRunner
from tomobench.record import Record, Request, Span
from tomobench.reference import paganin as ref
from tomobench.reference.compare import slice_rel_err
from tomobench.yardsticks.paganin import retrieval

ROOT = Path(__file__).resolve().parents[1]
CELL = "chain-paganin-roi720"
CPU = torch.device("cpu")
READERS = ("paganin_roofline.phase", "backproject_roofline.phase",
           "device.idle_pct.phase", "transport.to_host_gbps.phase",
           "runner.host_pct.phase", "transport.to_host_staged_pct.phase")


def _dataset(block):
    d = DataSet("tomo", block.shape, block.dtype,
                ("rotation_angle", "detector_y", "detector_x"))
    d.add_pattern("PROJECTION", core=("detector_y", "detector_x"),
                  slice_=("rotation_angle",))
    d.add_pattern("SINOGRAM", core=("rotation_angle", "detector_x"),
                  slice_=("detector_y",))
    return d


def _filter(block, **params):
    """A set-up filter over ``block``'s dataset, its input attached as
    the runner attaches it."""
    p = TP.PaganinFilter(in_datasets=["tomo"], out_datasets=["out"],
                         **params)
    ds = _dataset(block)
    p.in_data = [PluginData(ds)]
    p.setup([ds])
    return p


def _numpy_retrieval(block, tau, py, px):
    """Paganin in float64 NumPy: edges repeated, the padded frame's
    frequencies, cropped back."""
    inten = np.pad(np.exp(-block.astype(np.float64)),
                   ((0, 0), (py, py), (px, px)), mode="edge")
    ny, nx = inten.shape[1:]
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.fftfreq(nx)[None, :]
    filt = np.fft.ifft2(np.fft.fft2(inten, axes=(1, 2))
                        / (1.0 + tau * (kx ** 2 + ky ** 2)), axes=(1, 2))
    filt = filt.real[:, py:ny - py, px:nx - px]
    return -np.log(np.maximum(filt, 1e-6))


def _lin(rng, shape):
    return rng.uniform(0.05, 2.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("pads", [(0, 0), (3, 5), (10, 10)])
def test_padded_retrieval_equals_numpy_and_the_reference(rng, pads):
    """The filter's frames equal a float64 NumPy retrieval within float32
    FFT rounding, and the benchmark's reference (the same operations)
    to float32 rounding; pads wider than the frame repeat its edge."""
    block = _lin(rng, (5, 12, 20))
    tau = 30.0
    got = _filter(block, tau=tau, pad_y=pads[0],
                  pad_x=pads[1]).process_frames([torch.from_numpy(block)])
    np.testing.assert_allclose(got.numpy(),
                               _numpy_retrieval(block, tau, *pads),
                               rtol=1e-5, atol=1e-5)
    want = ref.retrieve(torch.from_numpy(block), tau, *pads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


def test_pads_change_the_edges_and_are_checked(rng):
    block = _lin(rng, (3, 16, 24))
    plain = _filter(block, tau=200.0).process_frames(
        [torch.from_numpy(block)])
    padded = _filter(block, tau=200.0, pad_y=6, pad_x=6).process_frames(
        [torch.from_numpy(block)])
    assert float((plain - padded).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="pads"):
        _filter(block, pad_y=-1)


def test_declared_bytes_and_span_attributes(rng):
    """``frame_bytes``: three complex64 padded frames and the float32
    result; the span: frames, the padded transform, the pads and the
    float32 projections read and written."""
    block = _lin(rng, (7, 12, 20))
    p = _filter(block, tau=5.0, pad_y=2, pad_x=4)
    assert p.frame_bytes([(12, 20)]) == 3 * 16 * 28 * 8 + 12 * 20 * 4
    assert p.span_attrs() == {"frames": 7, "fft_shape": [16, 28],
                              "pad": [2, 4], "bytes": 2 * 7 * 12 * 20 * 4}
    assert TP.RingRemoval().span_attrs() == {}


def test_gang_members_with_their_own_tau_equal_one_by_one(rng):
    """``process_frames_batched``: each frame scaled by its member's
    filter, with the pads, equals each member's own call."""
    taus, counts, pads = (1.0, 30.0, 400.0), [2, 3, 1], (2, 3)
    block = _lin(rng, (sum(counts), 10, 14))
    members = [_filter(block, tau=t, pad_y=pads[0], pad_x=pads[1])
               for t in taus]
    got = members[0].process_frames_batched(
        [torch.from_numpy(block)], [m.jit_constants() for m in members],
        counts)
    lo = 0
    for m, n in zip(members, counts):
        one = m.process_frames([torch.from_numpy(block[lo:lo + n])])
        np.testing.assert_allclose(got[lo:lo + n].numpy(), one.numpy(),
                                   rtol=0, atol=1e-6)
        lo += n


def _config(**geom):
    cfg = json.loads((ROOT / "tomobench" / "configs" /
                      "pco-edge-2560x720-paganin.json").read_text())
    cfg.update(geom)
    return cfg


GEOM = {"n_det": 64, "n_rows": 16, "n_angles": 60}


def _run_chain(cfg, scan):
    prog = program.load(ROOT)
    runner = prog.PluginRunner(program.chain(prog, cfg, scan),
                               prog.CudaTransport(CPU))
    vol = runner.transport.read(runner.run()[cfg["result"]])
    return vol, runner


@pytest.mark.parametrize("frames_a_block", [7, None])
def test_the_chain_through_the_runner_equals_the_reference(
        monkeypatch, frames_a_block):
    """The configuration's chain (tau 11,214 px², 10 px pads) at 64 ×
    16 × 60 through ``PluginRunner`` equals the plain reference, its
    projections retrieved 7 angles at a time, in each third of the rows
    (the first and last rows beside the pads); the Paganin step in
    frame blocks of 7 frames equals its one call bit for bit and its
    span says 9 blocks.  The reference without the pads, and its bf16
    control, miss the cell's limit."""
    cfg = _config(**GEOM)
    m = scans.ScanModel(2**34 + 3, 64, 16, 60, cfg["scan"])
    scan = m.raw(range(16), CPU)
    one, _ = _run_chain(cfg, scan)
    if frames_a_block is not None:
        per = 3 * 36 * 84 * 8 + 16 * 64 * 4
        monkeypatch.setattr(T, "frame_budget", lambda device, need: (
            frames_a_block * per if need == 60 * per else None))
    vol, runner = _run_chain(cfg, scan)
    np.testing.assert_array_equal(vol, one)
    (span,) = [s for s in runner.profiler.trace.spans()
               if s.name == "plugin.paganin_filter.process"]
    assert span.attrs["blocks"] == (1 if frames_a_block is None else 9)
    assert (span.attrs["frames"], span.attrs["fft_shape"],
            span.attrs["pad"]) == (60, [36, 84], [10, 10])
    assert span.attrs["bytes"] == 2 * 60 * 16 * 64 * 4
    params = ref.chain_params(cfg["process_list"])
    assert params["paganin"] == (11214.0, 10, 10)
    rows = [0, 7, 15]
    want = ref.reconstruct(scan, rows, params, CPU, block=7)
    errs = [slice_rel_err(vol[r], want[k]) for k, r in enumerate(rows)]
    assert max(errs) < 1e-5, errs
    limit = json.loads((ROOT / "tomobench" / "limits" / f"{CELL}.json")
                       .read_text())["recon_max_rel_err"]["limit"]
    unpadded = ref.reconstruct(scan, rows, {**params,
                                            "paganin": (11214.0, 0, 0)}, CPU)
    bf16 = ref.reconstruct(scan, rows, params, CPU, "bf16")
    for cand in (unpadded, bf16):
        assert max(slice_rel_err(cand[k], want[k])
                   for k in range(3)) > limit


def test_the_cell_is_found_by_name_and_the_spec_is_valid():
    spec = bench.load_spec(ROOT)
    assert bench.validate(spec, ROOT) == []
    cell = bench.cell(spec, ROOT, CELL)
    assert cell.chips == 1 and cell.config["n_rows"] == 720
    assert cell.config["name"] == cell.entry["config"] == \
        "pco-edge-2560x720-paganin"
    (entry,) = [c for c in spec["configs"] if c["name"] == cell.entry[
        "config"]]
    assert entry["reduced"] == ["n_rows"]
    assert cell.config["published"]["n_rows"] == 2160
    (pag,) = [e for e in cell.config["process_list"]
              if e["plugin"] == "paganin_filter"]
    assert pag["params"] == {"tau": 11214.0, "pad_y": 10, "pad_x": 10}
    assert cell.traffic["kind"] == "closed_phase"
    assert bench.driver("closed_phase").DRIVER is ClosedPhase
    assert issubclass(ClosedPhase, ClosedRunner)
    assert [m["name"] for m in cell.end_to_end()] == ["slices_per_s",
                                                      "setup_s"]
    assert [m["name"] for m in cell.per_layer()] == list(READERS)
    for name in READERS:
        assert callable(bench.reader(name).read)
    lim = cell.limits["recon_max_rel_err"]
    assert lim["lower"] < lim["limit"] < lim["upper"]


def test_the_frozen_count_and_its_reader():
    """2 × 5·P·log2 P operations a padded frame; the float32 projections
    read and written once; the reader counts a span once and leaves out
    one without the step's attributes (as the parent's program gives)."""
    w = retrieval(1801, 740, 2580, 10, 10)
    p = 740 * 2580
    assert w["flops"] == pytest.approx(1801 * 10 * p * math.log2(p))
    assert w["bytes"] == 2 * 4 * 1801 * 720 * 2560
    least = yardsticks.least_seconds(w, 1)
    assert least == pytest.approx(w["flops"] / 67e12)
    attrs = {"frames": 1801, "fft_shape": [740, 2580], "pad": [10, 10]}
    name = "plugin.paganin_filter.process"
    spans = [Span(name, 10.0, 10.5, attrs), Span(name, 10.0, 10.5, attrs)]
    rec = Record(CELL, 1, 0.0, 20.0,
                 [Request(0, 0.0, 9.0, 14.0, True, 720, spans)], [], {})
    read = bench.reader("paganin_roofline.phase").read
    assert read(rec) == pytest.approx(100.0 * least / 0.5)
    rec.requests[0].spans = [Span(name, 10.0, 10.5, {"blocks": 1})]
    assert read(rec) is None


def test_a_program_without_the_pads_refuses_before_the_scans():
    spec = bench.load_spec(ROOT)
    cell = bench.cell(spec, ROOT, CELL)
    prog = program.load(ROOT)

    class Unpadded(TP.PaganinFilter):
        parameters = {"tau": 10.0}

    plugins = {**prog.plugins, "paganin_filter": Unpadded}
    drv = ClosedPhase(cell, type(prog)(**{**vars(prog),
                                          "plugins": plugins}),
                      CPU, 5, 1.0)
    drv.inputs = lambda: pytest.fail("the scans were made")
    with pytest.raises(ValueError, match="pad_x"):
        drv.setup()


def test_a_tiny_copy_of_the_cell_runs_end_to_end(tmp_path):
    """The cell's configuration at 64 × 16 × 60 and its traffic, added
    to a throwaway checkout: a traced run reads ``correct`` and every
    program-span reader of the cell; the bf16 control reads not
    correct."""
    from tomobench.tests import tiny
    root = tiny.make_root(tmp_path, extra_metric=False)
    pkg = root / "tomobench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (pkg / "configs" / "tiny-phase.json").write_text(json.dumps(
        {**_config(**GEOM), "name": "tiny-phase"}))
    spec["configs"].append({"name": "tiny-phase", "source": "tiny",
                            "file": "tomobench/configs/tiny-phase.json",
                            "reduced": ["n_det", "n_rows", "n_angles"],
                            "why": "CPU tests"})
    traffic = json.loads((pkg / "traffic" / "scan-roi720.json").read_text())
    (pkg / "traffic" / "tiny-phase.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "tiny-phase.json").write_text(
        (pkg / "limits" / f"{CELL}.json").read_text())
    spec["workloads"].append({"name": "tiny-phase", "config": "tiny-phase",
                              "traffic": "tiny-phase", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-phase")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = tiny.run_cell(root, "tiny-phase", 2**33 + 5, 0.5, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["recon_max_rel_err"]["value"] < 1e-5
    # no device off the card: the idle share has nothing to read, and a
    # read on the CPU is never staged
    assert set(res["metrics"]) == set(READERS) - {
        "device.idle_pct.phase", "transport.to_host_staged_pct.phase"}
    assert not {"jax", "jaxlib", "flax", "repro"} & set(r["modules"])
    r = tiny.run_cell(root, "tiny-phase", 7, 0.3, control="bf16")
    assert r["rc"] == 0 and r["result"]["correct"] is False


@pytest.mark.gpu
def test_the_step_at_the_cells_size_on_the_card():
    """The Paganin step over 1801 corrected 720 × 2560 projections
    (padded to 740 × 2580) through ``CudaTransport`` runs in more than
    one frame block and equals the plain reference's retrieval, 64
    projections at a time, within 2e-5 (float32 transforms of other
    batch sizes on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = _config()
    m = scans.ScanModel(2**33 + 9, cfg["n_det"], cfg["n_rows"],
                        cfg["n_angles"], cfg["scan"])
    scan = scans.whole(m, dev)
    pl = program.chain(program.load(ROOT),
                       {**cfg, "process_list": cfg["process_list"][:2] +
                        [{"plugin": "hdf5_saver", "in": ["tomo"]}]}, scan)
    runner = PluginRunner(pl, CudaTransport(dev))
    got = runner.transport.read(runner.run()["tomo"])
    (span,) = [s for s in runner.profiler.trace.spans()
               if s.name == "plugin.paganin_filter.process"]
    assert span.attrs["blocks"] > 1
    assert span.attrs["fft_shape"] == [740, 2580]
    dark = torch.as_tensor(scan["dark"].astype(np.float32), device=dev)[None]
    flat = torch.as_tensor(scan["flat"].astype(np.float32), device=dev)[None]
    worst = 0.0
    for a0 in range(0, cfg["n_angles"], ref.ANGLES):
        raw = torch.as_tensor(scan["data"][a0:a0 + ref.ANGLES], device=dev)
        want = ref.retrieve(ref.chain.correct(raw, dark, flat), 11214.0,
                            10, 10)
        have = torch.as_tensor(got[a0:a0 + ref.ANGLES], device=dev)
        worst = max(worst, float((have - want).abs().max()))
    assert worst < 2e-5, worst
