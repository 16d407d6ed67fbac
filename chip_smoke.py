#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: torch/CUDA versions, the nvcc path, the card's name and
   power limit (nvidia-smi); builds the CUDA kernels and times the build;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the main paths' shapes, with the tolerances of the
   JAX package's kernel tests; times the kernel, the plain version and,
   where one PyTorch call computes the same function, that call (the
   spectrum scale and ``spec * filt`` in alternating rounds);
   correction also as one launch for a gang at the gang's shape (each
   member equal to a launch for it alone, bit for bit), and the
   spectrum scale as one launch for a sweep of 4 cutoffs with a filter
   row per member (bit for bit the plain version's and each member's
   launch alone).  Flash
   attention is held at the serving shape in bf16 against ``mha_ref``
   (rtol 1e-2, atol 1e-3, tighter than the JAX test's 5e-2 at S 64,
   where outputs are larger) and against ``mha_tiled_ref``, which
   repeats the bf16 kernel's tiled arithmetic (one bf16 output rounding,
   rtol 2**-7, atol 1e-5), and over an fp32 sweep (2e-5: causal or
   not, groups 1, 4 and 48, D 64 and 128, ragged lengths); a line gives
   the fp32 kernel's time at the serving shape and the bf16 kernel's
   achieved TFLOP/s.  Backprojection is also held, on four full image
   rows, against ``backproject_tiled_ref``, which repeats its arithmetic
   (rtol 1e-5, atol 1e-6); a line gives its work (positions once per
   (pixel, angle), lerps per slice), its bound and its achieved G
   updates/s; another gives its time at the
   main geometry for 1 to 16 slices through the entry point and with
   each group size of slices a block may own, which must all give the
   entry point's output bit for bit;
3. the tomography path: ``standard_chain(n_det=2560, n_angles=1801,
   n_rows=16)`` through ``PluginRunner`` on ``CudaTransport("cuda")``
   with every kernel's launch count set to 0 just before; the raw scan
   (seed 0) is simulated on the card once, here, and handed to the
   loader through its ``scan`` data parameter; checks that every kernel
   launched and that the reconstruction matches the phantom
   (correlation > 0.85 over the [8:-8] crop);
3a. the service, gang: ``repro_torch.launch.pipeline_serve.main`` with 2
   jobs of 2560 x 1801 x 8 (seeds 0 and 1; 8 rows, so the gang's 16
   slices are phase 3's) on one worker, gang-batched, each job verified
   against a serial run (rtol 1e-3, atol 1e-4); the kernels' counts are
   set to 0 just before: one gang, and exactly one launch of each kernel
   over the gang's steps (one more each per serial verification run);
3b. streaming: phase 3's scan as a streaming job through ``JobQueue`` +
   ``PipelineScheduler`` on ``CudaTransport("cuda")``: its raw frames
   appended in slabs of 16-128 frames (``default_rng(0)``), each once
   the job has consumed the previous one, a ``preview`` once half the
   angles have landed; the reconstruction must equal phase 3's bit for
   bit, with one correction launch per pump;
3c. resume: the same streaming job with a ``CheckpointStore``, slabs of
   128-256 frames, each once the previous one is checkpointed; the
   scheduler is shut down after about half the frames, the same job id resubmitted to a fresh queue and scheduler
   with the same store and fed from the checkpoint's watermark; the
   reconstruction must equal phase 3's bit for bit;
3d. the HTTP service on the card: ``PipelineService`` (card, gang
   batching, cost analysis) on 127.0.0.1:0 driven by ``PipelineClient``:
   a sweep of 4 ``sinogram_filter.cutoff`` values (1.0, 0.8, 0.6, 0.4)
   at 2560 x 1801 x 4 rows per variant must run as 1 gang with no
   fallback, each gang step's span recording one launch of its kernel
   (and one more launch each in the cost analysis' run before the
   timer); each variant, fetched through ``GET /sweeps/{id}/result``,
   is held against the same chain run solo on the card with that cutoff
   (rtol 1e-3, atol 1e-4); a 2-node workflow (the chain at 2560 x 1801
   x 2 rows, then ``UpstreamLoader -> Downsample -> Quantify`` on its
   recon) must finish with the downstream fed the upstream's tensor on
   the card; the first variant's OTLP and JSON traces must hold the
   same spans, every kernel step's process span must carry flops, bytes
   accessed and peak memory, its flops and bytes equal to the kernels'
   ``cost()`` counts for the gang launch, and no critical SLO rule may
   fire;
3e. remote workers: ``PipelineService(workers_remote=True)`` (a broker
   on 127.0.0.1:0) and worker processes from ``spawn_local_workers``
   (``--transport cuda``, gangs of up to 4, a shared checkpoint
   directory, each with its own empty kernel-library store).  Worker A
   runs the chain at 2560 x 1801 x 2 rows first: it must build the
   library (a ``kernels.build`` span) and publish it.  Phase 3d's sweep
   is then leased by A as one gang: every gang step's process span
   records one launch of its kernel (read from ``GET /jobs/{id}/trace``;
   the launches happen in A's process), no fallback, each variant held
   against phase 3d's result for its cutoff (rtol 1e-3, atol 1e-4).  A
   cold worker B registers and must report ``prefetched`` >= 1; A is
   paused (SIGSTOP) while B leases the 2-row chain, whose trace must
   show ``executable.fetch``, no ``kernels.build`` and ``nvcc_runs`` 0
   on its ``kernels.load`` span, with A's result bit for bit.  Last, a
   checkpointed 2-row chain with ``slow_identity`` (from
   ``tests/torch_slow_plugins.py``, which the workers ``--import``)
   after the correction: the worker holding its lease is SIGKILLed after
   its first ``checkpoint.save``; the survivor must finish it with
   ``resumed_from`` >= 1, bit for bit ``PluginRunner`` on the card in
   this process;
4. chain parity: one small scan through the chain on the card with the
   kernels and on the CPU with the plain versions (rtol 1e-3, atol 1e-4);
5. the serving path: granite-8b at full width (36 layers, d_model 4096,
   bf16, random weights from seed 0) with ``use_flash`` through
   ``ContinuousBatcher``: 8 requests of 2048 prompt tokens and 64 new
   tokens each on 4 slots, ``max_len`` 4096; the flash kernel's count is
   set to 0 just before and must read 8 prefills x 36 layers = 288;
   every logit finite, every token in the vocabulary; then three decode
   steps of a fresh batch under ``torch.profiler`` give the kernel time
   of a step, and that kernel time against the serving run's median
   step (two different windows) an estimate of the device's idle share;
6. LM parity: the granite-8b smoke model (fp32) with the kernel on the
   card against the plain version on the CPU (same weights, 5 requests
   on 2 slots: identical tokens, prefill logits within 2e-4), and at
   full width with 2 layers the kernel path against the plain path on
   the card: in fp32 (prefill logits within 2e-4) and in bf16, the
   serving dtype, where the kernel may move the logits by no more than
   the bf16 rounding of the block outputs does (the plain bf16 path
   against the plain path in fp32 on the same weights); a line gives
   the distance that check reads with two planted faults in the
   prefill's attention (the last V tile zero-filled; P rounded to bf16
   in the kernel's tiled arithmetic), against its limit.

The line before the last is a JSON object ``{"kernels": [...]}`` (the
correction row also gives the gang launch, ``batched_*``, and the
spectrum-scale row the per-member launch of a 4-variant sweep); the
last line is ``{"ok": true, "device": {...}}``.  Phases 3a-3e print one
``{"service_gang": ...}``, ``{"streaming": ...}``,
``{"stream_resume": ...}``, ``{"http_service": ...}`` and
``{"remote_workers": ...}`` line each.
Every bound is computed from the kernels' own ``cost()`` counts, the
numbers the service's process spans carry.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside this file, it
exits non-zero and prints no result.

``python3 chip_smoke.py --bp-slices`` runs phase 1 and the backprojection
slice sweep alone.  Copied into a checkout whose kernel library has no
``backproject_group``, it times that checkout's entry point alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # dense tensor-core rate
#: the main path: PCO.edge 5.5 width (2560 columns), a 180° scan of 1801
#: projections; rows cut from the detector's 2160 to 16
MAIN = {"n_det": 2560, "n_angles": 1801, "n_rows": 16}
PARITY = {"n_det": 256, "n_angles": 256, "n_rows": 2}
#: flash attention at the serving shape: granite-8b's (B, Hq, Hkv, S, D)
#: for one 2048-token prompt
FLASH_MAIN = (1, 32, 8, 2048, 128)
#: (rtol, atol) there: both sides compute in fp32 from the same bf16
#: inputs, so they differ by the output's bf16 rounding (one ulp is at
#: most 2**-7 of the value) and the order of the sums; at S 2048 an output
#: is typically 0.02-0.07, so a dropped or misread 64-key tile moves it by
#: several times the atol
FLASH_BF16_TOL = (1e-2, 1e-3)
#: (rtol, atol) against ``mha_tiled_ref``, which repeats the bf16
#: kernel's arithmetic: the two differ in fp32 by exp's last bits, the
#: order of the sums and the split's 2**-18 residual (~1e-6 of an
#: output), which can put them on two sides of one bf16 rounding of the
#: output (at most 2**-7 of its value)
FLASH_TILED_TOL = (2.0 ** -7, 1e-5)
#: fp32 sweep: group sizes 1, 4 and 48 (granite-34b's MQA), D 64 and 128,
#: lengths no 64-row tile divides
FLASH_SWEEP = [(2, 8, 8, 512, 64), (1, 32, 8, 1000, 128),
               (1, 48, 1, 1000, 128), (2, 8, 2, 1000, 64)]
#: the serving path: requests, slots, prompt and new tokens, cache length
#: (granite-8b-code's 4K context)
SERVE = {"arch": "granite-8b", "requests": 8, "slots": 4,
         "prompt_len": 2048, "max_new": 64, "max_len": 4096}
#: alternating rounds of 20 timed launches each for the spectrum scale
#: and `spec * filt`
SPECTRUM_ROUNDS = 5
#: decode steps under torch.profiler after the serving run
PROFILED_STEPS = 3
#: image rows at which the backprojection kernel is held against its own
#: arithmetic (``backproject_tiled_ref``): the edges and the centre
BP_TILED_ROWS = [0, 5, 1280, 2555]
#: (rtol, atol) there: the two differ only where the float64 emulation of
#: an FMA rounds twice; the position contracted into an FMA moves pixels
#: by up to ~2e-5 at this geometry (tests/test_torch_kernels.py)
BP_TILED_TOL = (1e-5, 1e-6)
#: slice counts of the backprojection sweep (main geometry otherwise),
#: and the group sizes of slices a block of the kernel may own
BP_SWEEP_SLICES = (1, 2, 3, 4, 6, 8, 12, 16)
BP_GROUPS = (1, 2, 4, 8)
#: the service phases: the gang's jobs (8 rows each, so the gang's 16
#: slices are phase 3's), and the streaming slabs' sizes in frames
GANG = {"jobs": 2, "n_rows": 8}
STREAM_SLABS = (16, 128)
RESUME_SLABS = (128, 256)
#: seconds a streaming phase waits for the job to take up a slab
STREAM_WAIT_S = 300
#: phase 3d: the sweep (rows per variant cut to 4; its variants and the
#: solo runs they are held against share one simulated scan) and the
#: workflow's chain
SWEEP = {"cutoffs": [1.0, 0.8, 0.6, 0.4], "n_rows": 4}
WORKFLOW_ROWS = 2
#: seconds phase 3d waits for the sweep or the workflow
HTTP_WAIT_S = 600
#: phase 3e: rows of the solo and the kill/resume jobs, the broker's lease
#: TTL (s), the kill/resume job's pause (s) in its slow step, the largest
#: gang a worker leases, and seconds the phase waits for any one thing
REMOTE = {"n_rows": 2, "lease_ttl": 5.0, "delay": 3.0, "max_batch": 4}
REMOTE_WAIT_S = 600


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_bound(work: dict, peak_flops: float = PEAK_FP32_FLOPS
               ) -> tuple[float, str]:
    """:func:`bound_ms` of a kernel's ``cost()`` counts."""
    return bound_ms(work["bytes"], work["flops"], peak_flops)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` in ms, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bp_slice_sweep() -> dict:
    """Backprojection at the main geometry for each slice count of
    ``BP_SWEEP_SLICES``: ms through the entry point (``backproject_cuda``)
    and, where the kernel library has ``backproject_group``, with each
    group size of ``BP_GROUPS``, whose outputs must equal the entry
    point's bit for bit (each slice's sum is the same arithmetic)."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.backproject.kernel import (
        backproject_cuda, rays_on_detector)
    from repro_torch.kernels.backproject.kernel import cost as bp_cost
    from repro_torch.tomo import ParallelGeometry

    n_det, n_ang = MAIN["n_det"], MAIN["n_angles"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sino_all = torch.randn((max(BP_SWEEP_SLICES), n_ang, n_det),
                           generator=gen, device=dev)
    angles = torch.from_numpy(ParallelGeometry(n_ang, n_det, 1).angles
                              .astype(np.float32)).to(dev)
    cos_t, sin_t = torch.cos(angles), torch.sin(angles)
    scale = float(np.float32(np.pi / n_ang))
    centre = (n_det - 1) / 2.0
    groups = (BP_GROUPS if hasattr(build.library(), "backproject_group")
              else ())
    if groups:
        group_fn = build.function(
            "backproject_group", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
            + (ctypes.c_float, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p))
    result = {}
    for n_sl in BP_SWEEP_SLICES:
        sino = sino_all[:n_sl]
        want = backproject_cuda(sino, cos_t, sin_t, n_det)
        ms = {"entry": cuda_ms(
            lambda: backproject_cuda(sino, cos_t, sin_t, n_det), 3)}
        out = torch.empty_like(want)
        for g in groups:
            def launch(g=g):
                build.check(group_fn(
                    build.ptr(sino), build.ptr(cos_t), build.ptr(sin_t),
                    build.ptr(out), n_sl, n_ang, n_det, n_det, centre,
                    scale, g, build.stream(sino.device)),
                    "backproject_group")
            out.fill_(float("nan"))
            launch()
            if not torch.equal(out, want):
                fail(f"backprojection: groups of {g} differ from the entry "
                     f"point at {n_sl} slices")
            ms[f"group_{g}"] = cuda_ms(launch, 3)
        result[n_sl] = ms
    return result


def http_service_phase(dev, compare, wrappers, costs,
                       rays_on_detector) -> tuple[dict, np.ndarray]:
    """Phase 3d: ``PipelineService`` on the card driven over HTTP by
    ``PipelineClient``: a 4-value cutoff sweep as one gang, a 2-node
    workflow, and the first variant's telemetry.  Returns the phase's
    numbers and the sweep's stacked result (phase 3e's reference); fails
    on any check."""
    import torch
    from repro_torch.core import CudaTransport, PluginRunner
    from repro_torch.kernels.sino_filter.ref import make_filter
    from repro_torch.service import PipelineClient, PipelineService
    from repro_torch.tomo import ParallelGeometry, standard_chain
    from repro_torch.tomo.plugins import simulated_scan

    n_det, n_ang = MAIN["n_det"], MAIN["n_angles"]
    cutoffs, n_rows = SWEEP["cutoffs"], SWEEP["n_rows"]
    n_var = len(cutoffs)
    svc = PipelineService(device=dev, n_workers=1, batch_identical=True,
                          batch_max=n_var, cost_analysis=True)
    host, port = svc.serve(host="127.0.0.1", port=0)
    client = PipelineClient(f"http://{host}:{port}", timeout=HTTP_WAIT_S)
    try:
        # -- the sweep: 4 variants, one gang
        # the scan the variants' loaders simulate (seed 0), held here so
        # that they share it with each other and with the solo runs below
        t0 = time.perf_counter()
        scan = simulated_scan(n_det, n_ang, n_rows, device=dev)
        simulate_s = time.perf_counter() - t0
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        reply = client.sweep(
            standard_chain(n_det=n_det, n_angles=n_ang, n_rows=n_rows),
            {"plugin": "sinogram_filter", "param": "cutoff",
             "values": cutoffs}, metric="sharpness")
        snap = client.wait_sweep(reply["sweep_id"], timeout=HTTP_WAIT_S)
        sweep_wall_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        if snap["state"] != "done":
            fail(f"http sweep: {snap['state']}: "
                 f"{[v.get('error') for v in snap['variants']]}")
        stats = client.stats()
        if stats["gangs_run"] != 1 or stats["gang_fallbacks"] != 0:
            fail(f"http sweep: {stats['gangs_run']} gangs, "
                 f"{stats['gang_fallbacks']} fallbacks (want 1 and 0)")
        first = reply["job_ids"][0]
        trace = client.trace(first)
        spans = [sp for sp in trace["spans"]
                 if sp["name"].endswith(".process")]
        step_launches = {}
        for sp in spans:
            if sp["attrs"].get("gang") != n_var:
                fail(f"http sweep: {sp['name']} ran as a gang of "
                     f"{sp['attrs'].get('gang')}, not {n_var}")
            for key, n in sp["attrs"].items():
                if key.startswith("launches."):
                    name = key.split(".", 1)[1]
                    step_launches[name] = step_launches.get(name, 0) + n
        if step_launches != {k: 1 for k in wrappers}:
            fail(f"http sweep: kernel launches over the gang's steps "
                 f"{step_launches}, expected one of each")
        if spans_of(spans, "sinogram_filter")["attrs"].get(
                "launches.spectrum_scale") != 1:
            fail("http sweep: the filter step did not launch the "
                 "spectrum scale exactly once")
        # the cost analysis runs each new step once before its timer
        if launches != {k: 2 for k in wrappers}:
            fail(f"http sweep: launches over the sweep {launches}, "
                 f"expected 2 of each (the cost run and the step)")
        process_s = sum(sp["end"] - sp["start"] for sp in spans)
        for jid in reply["job_ids"]:
            simulate_s += sum(
                sp["end"] - sp["start"] for sp in client.trace(jid)["spans"]
                if sp["name"] == "plugin.synthetic_tomo_loader.setup")
        # -- telemetry of the first variant
        otlp = client.trace(first, otlp=True)
        n_otlp = sum(len(ss["spans"]) for rs in otlp["resourceSpans"]
                     for ss in rs["scopeSpans"])
        if n_otlp != len(trace["spans"]):
            fail(f"http telemetry: OTLP holds {n_otlp} spans, the JSON "
                 f"trace {len(trace['spans'])}")
        geom = ParallelGeometry(n_ang, n_det, n_rows)
        theta = torch.from_numpy(geom.angles.astype(np.float32)).to(dev)
        rays = rays_on_detector(torch.cos(theta), torch.sin(theta), n_det,
                                n_det)
        # the variants simulate one scan (seed 0), so their dark and flat
        # agree and the correction takes them once; their filters differ,
        # so the spectrum scale takes one row per variant
        want_cost = {
            "dark_flat_correction": costs["correction"](
                n_var * n_ang, n_rows * n_det, 2),
            "sinogram_filter": costs["spectrum_scale"](
                n_var * n_rows * n_ang, make_filter(n_det).shape[0], n_var),
            "fbp_recon": costs["backprojection"](
                n_var * n_rows, n_ang, n_det, n_det, rays)}
        step_costs = {}
        for plugin, want in want_cost.items():
            attrs = spans_of(spans, plugin)["attrs"]
            if not all(k in attrs for k in ("flops", "bytes_accessed",
                                            "peak_memory")):
                fail(f"http telemetry: {plugin}'s process span lacks cost "
                     f"attributes: {sorted(attrs)}")
            if (attrs["flops"], attrs["bytes_accessed"]) != (
                    want["flops"], want["bytes"]):
                fail(f"http telemetry: {plugin}'s span reads flops "
                     f"{attrs['flops']} bytes {attrs['bytes_accessed']}, "
                     f"the kernel's cost() {want}")
            step_costs[plugin] = {k: attrs.get(k) for k in (
                "flops", "bytes_accessed", "peak_memory")}
        metrics_text = client.metrics()
        slo = client.slo()
        if "jobs_completed" not in metrics_text:
            fail("http telemetry: /metrics has no jobs_completed")
        if slo["critical_firing"]:
            fail(f"http telemetry: critical SLO rules fire: "
                 f"{slo['critical_firing']}")
        ready = client.health(ready=True)
        # -- the stacked result, held against solo runs on the card
        t0 = time.perf_counter()
        stacked = client.sweep_result(reply["sweep_id"])
        download_s = time.perf_counter() - t0
        if stacked.shape != (n_var, n_rows, n_det, n_det):
            fail(f"http sweep: result shape {stacked.shape}")
        errs = []
        for k, cutoff in enumerate(cutoffs):
            pl = standard_chain(n_det=n_det, n_angles=n_ang, n_rows=n_rows,
                                device=dev)
            pl.entries[0].params["scan"] = scan
            pl.entries[3].params["cutoff"] = cutoff
            r = PluginRunner(pl, CudaTransport(dev))
            want = r.run()["recon"].backing
            errs.append(compare(f"http sweep: variant {k} (cutoff "
                                f"{cutoff}) against its solo run",
                                torch.from_numpy(stacked[k]).to(dev), want,
                                1e-3, 1e-4))
            del r, want
        del scan
        # -- the workflow: the chain, then downsample + quantify
        down = {"version": 1, "plugins": [
            {"plugin": "upstream_loader",
             "params": {"data": {"from_job": "recon", "dataset": "recon"}},
             "out_datasets": ["vol"]},
            {"plugin": "downsample", "params": {"factor": 2},
             "in_datasets": ["vol"], "out_datasets": ["small"]},
            {"plugin": "quantify", "in_datasets": ["small"],
             "out_datasets": ["stats"]},
            {"plugin": "hdf5_saver", "in_datasets": ["stats"]}]}
        t0 = time.perf_counter()
        wf = client.workflow({
            "recon": {"process_list": standard_chain(
                n_det=n_det, n_angles=n_ang, n_rows=WORKFLOW_ROWS, seed=1)},
            "stats": {"process_list": down}}, workflow_id="wf-chip")
        wsnap = client.wait_workflow(wf["workflow_id"], timeout=HTTP_WAIT_S)
        workflow_s = time.perf_counter() - t0
        if wsnap["state"] != "done":
            fail(f"http workflow: {wsnap['state']}: {wsnap}")
        fed = svc.queue.job("wf-chip/stats").process_list.entries[0] \
            .params["data"]
        upstream, _ = svc.result_dataset("wf-chip/recon", "recon")
        if not (isinstance(fed, torch.Tensor) and fed.device.type == "cuda"
                and fed is upstream.backing):
            fail(f"http workflow: the downstream read {type(fed)} on "
                 f"{getattr(fed, 'device', None)}, not the upstream's "
                 f"tensor on the card")
        stats_out = client.result("wf-chip/stats")
        if stats_out.shape != (WORKFLOW_ROWS, 4) or \
                not np.isfinite(stats_out).all():
            fail(f"http workflow: stats {stats_out.shape}")
    finally:
        svc.stop()
    return {
        "sweep": {"variants": n_var, "cutoffs": cutoffs,
                  "shape": [n_var, n_rows, n_det, n_det],
                  "wall_s": sweep_wall_s,
                  "process_s": process_s,
                  "variants_per_s": n_var / process_s,
                  "step_s": {sp["attrs"]["plugin"]: sp["end"] - sp["start"]
                             for sp in spans},
                  "simulate_s": simulate_s,
                  "step_launches": step_launches,
                  "launches_with_cost_runs": launches,
                  "gang_fallbacks": stats["gang_fallbacks"],
                  "max_abs_err_vs_solo": errs,
                  "best_variant": snap["best_variant"],
                  "result_mb": n_var * n_rows * n_det * n_det * 4 / 1e6,
                  "result_download_s": download_s,
                  "result_mb_per_s": n_var * n_rows * n_det * n_det * 4
                  / 1e6 / download_s},
        "telemetry": {"spans": len(trace["spans"]), "otlp_spans": n_otlp,
                      "step_costs": step_costs, "ready": ready["ready"],
                      "slo_firing": slo["firing"]},
        "workflow": {"n_rows": WORKFLOW_ROWS, "wall_s": workflow_s,
                     "state": wsnap["state"]}}, stacked


def remote_workers_phase(dev, sweep_ref: np.ndarray) -> dict:
    """Phase 3e: a broker-mode ``PipelineService`` and worker processes
    on the card (see the module docstring).  ``sweep_ref`` is phase 3d's
    stacked sweep result.  Returns the phase's numbers; fails on any
    check, with the workers' logs."""
    import importlib
    import os
    import signal
    import threading

    from repro_torch.core import CudaTransport, PluginRunner
    from repro_torch.service import (PipelineClient, PipelineService,
                                     from_spec, to_spec)
    from repro_torch.service.worker import spawn_local_workers
    from repro_torch.tomo import standard_chain

    t_phase = time.perf_counter()
    n_det, n_ang, n_rows = MAIN["n_det"], MAIN["n_angles"], REMOTE["n_rows"]
    cutoffs = SWEEP["cutoffs"]
    tmp = Path(tempfile.mkdtemp(prefix="chip-remote-"))
    tests_dir = str(ROOT / "tests")
    sys.path.insert(0, tests_dir)
    importlib.import_module("torch_slow_plugins")   # the broker admits it
    svc = PipelineService(device=dev, workers_remote=True,
                          lease_ttl=REMOTE["lease_ttl"], sweep_interval=0.2,
                          executables_dir=str(tmp / "spool"))
    host, port = svc.serve(host="127.0.0.1", port=0)
    client = PipelineClient(f"http://{host}:{port}", timeout=REMOTE_WAIT_S)
    procs, logs = {}, {}

    def spawn(wid):
        logs[wid] = open(tmp / f"{wid}.log", "w")
        procs[wid] = spawn_local_workers(
            client.base_url, 1, transport="cuda", device=str(dev),
            max_batch=REMOTE["max_batch"], poll=0.05,
            checkpoint_dir=str(tmp / "ck"), worker_ids=[wid],
            executables_dir=str(tmp / f"w{wid}"),
            imports=("torch_slow_plugins",), pythonpath_extra=(tests_dir,),
            stdout=logs[wid])[0]

    def die(msg):
        for wid, log in logs.items():
            log.flush()
            tail = (tmp / f"{wid}.log").read_text()[-3000:]
            print(f"--- worker {wid} log\n{tail}", file=sys.stderr)
        fail(f"remote workers: {msg}")

    def until(cond, what):
        deadline = time.time() + REMOTE_WAIT_S
        while True:
            got = cond()
            if got:
                return got
            if time.time() > deadline:
                die(f"timed out waiting for {what}")
            time.sleep(0.05)

    def registered(wid):
        return until(lambda: client.workers().get(wid), f"worker {wid}")

    def done(jid, what):
        snap = client.wait(jid, timeout=REMOTE_WAIT_S)
        if snap["state"] != "done":
            die(f"{what}: {snap['state']}: {snap.get('error')}")
        return snap

    def spans(jid, name=None):
        got = client.trace(jid)["spans"]
        return [sp for sp in got if name is None or sp["name"] == name]

    def wall(sps):
        return sum(sp["end"] - sp["start"] for sp in sps)

    def step_launches(jid):
        out = {}
        for sp in spans(jid):
            for key, n in sp.get("attrs", {}).items():
                if key.startswith("launches."):
                    out[key.split(".", 1)[1]] = \
                        out.get(key.split(".", 1)[1], 0) + n
        return out

    def held(name, got, want):
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        if not np.allclose(got, want, rtol=1e-3, atol=1e-4):
            die(f"{name}: max abs err {err:.3e} beyond rtol 1e-3, atol 1e-4")
        return err

    chain_spec = to_spec(standard_chain(n_det=n_det, n_angles=n_ang,
                                        n_rows=n_rows))
    one_each = {"correction": 1, "spectrum_scale": 1, "backprojection": 1}
    try:
        # -- A: the first job builds the library (empty store) and
        # publishes it to the broker's spool
        spawn("A")
        registered("A")
        ja = client.submit(chain_spec, job_id="remote-a")
        sa = done(ja, "A's first job")
        if not spans(ja, "kernels.build"):
            die("A's first job built no kernel library")
        a_build_s = wall(spans(ja, "kernels.build"))
        if step_launches(ja) != one_each:
            die(f"A's first job launched {step_launches(ja)}")
        res_a = client.result(ja)
        spool = svc.broker.executables.stats()
        if spool["entries"] < 1:
            die("A published no library to the broker's spool")
        # -- phase 3d's sweep, leased by A as one gang
        t0 = time.perf_counter()
        reply = client.sweep(
            standard_chain(n_det=n_det, n_angles=n_ang,
                           n_rows=SWEEP["n_rows"]),
            {"plugin": "sinogram_filter", "param": "cutoff",
             "values": cutoffs})
        snap = client.wait_sweep(reply["sweep_id"], timeout=REMOTE_WAIT_S)
        sweep_wall_s = time.perf_counter() - t0
        if snap["state"] != "done":
            die(f"sweep: {snap['state']}")
        proc = [sp for sp in spans(reply["job_ids"][0])
                if sp.get("attrs", {}).get("phase") == "process"]
        if {sp["attrs"].get("gang") for sp in proc} != {len(cutoffs)}:
            die(f"sweep: steps ran as gangs of "
                f"{[sp['attrs'].get('gang') for sp in proc]}")
        fallbacks = sum(len(spans(j, "gang.fallback"))
                        for j in reply["job_ids"])
        if fallbacks or step_launches(reply["job_ids"][0]) != one_each:
            die(f"sweep: {fallbacks} fallbacks, launches "
                f"{step_launches(reply['job_ids'][0])}")
        if {s["worker_id"] for s in snap["variants"]} != {"A"}:
            die(f"sweep: leased by {[s['worker_id'] for s in snap['variants']]}")
        stacked = client.sweep_result(reply["sweep_id"])
        sweep_errs = [held(f"sweep variant {k} (cutoff {c}) vs phase 3d",
                           stacked[k], sweep_ref[k])
                      for k, c in enumerate(cutoffs)]
        sweep_bitwise = bool(np.array_equal(stacked, sweep_ref))
        uploads = [sp for j in reply["job_ids"]
                   for sp in spans(j, "result.upload")]
        upload_mb = stacked[0].nbytes / 1e6 * len(uploads)
        process_s = wall(proc)
        del stacked
        # -- B: a cold worker with an empty store prefetches the library
        spawn("B")
        registered("B")
        until(lambda: client.workers()["B"]["prefetched"] >= 1,
              "B to report its prefetch")
        os.kill(procs["A"].pid, signal.SIGSTOP)   # B takes the next job
        try:
            jb = client.submit(chain_spec, job_id="remote-b")
            until(lambda: client.status(jb)["worker_id"] == "B",
                  "B to lease its first job")
        finally:
            os.kill(procs["A"].pid, signal.SIGCONT)
        sb = done(jb, "B's first job")
        names_b = [sp["name"] for sp in spans(jb)]
        loads = spans(jb, "kernels.load")
        if "executable.fetch" not in names_b or "kernels.build" in names_b \
                or len(loads) != 1 or loads[0]["attrs"]["nvcc_runs"] != 0:
            die(f"B's first job: spans {names_b}, kernels.load "
                f"{[sp['attrs'] for sp in loads]}")
        if step_launches(jb) != one_each:
            die(f"B's first job launched {step_launches(jb)}")
        res_b = client.result(jb)
        if not np.array_equal(res_b, res_a):
            die(f"B's result differs from A's (max abs err "
                f"{float(np.max(np.abs(res_b - res_a))):.3e})")
        # -- kill and resume: whichever worker leases the job is killed
        # after its first checkpoint; the other finishes it
        kill_spec = dict(chain_spec, plugins=list(chain_spec["plugins"]))
        kill_spec["plugins"].insert(2, {
            "plugin": "slow_identity", "params": {"delay": REMOTE["delay"]},
            "in_datasets": ["tomo"], "out_datasets": ["tomo"]})
        jk = client.submit(kill_spec, job_id="remote-kill")
        ref = {}

        def reference():           # this process, on the card
            r = PluginRunner(from_spec(kill_spec, device=dev),
                             CudaTransport(dev))
            ref["recon"] = r.transport.read(r.run()["recon"])

        ref_thread = threading.Thread(target=reference)
        ref_thread.start()
        snap = until(lambda: (lambda s: s if s["state"] == "running"
                              and s["plugin_index"] >= 1
                              and s["worker_id"] else None)(
                                  client.status(jk)),
                     "the kill job's first checkpoint")
        victim = snap["worker_id"]
        os.kill(procs[victim].pid, signal.SIGKILL)
        procs[victim].wait(timeout=60)
        t_kill = time.perf_counter()
        snap_k = done(jk, "the kill/resume job")
        resume_s = time.perf_counter() - t_kill
        if snap_k["resumed_from"] < 1 or snap_k["worker_id"] == victim:
            die(f"kill/resume: resumed_from {snap_k['resumed_from']} on "
                f"{snap_k['worker_id']} (victim {victim})")
        ref_thread.join(timeout=REMOTE_WAIT_S)
        res_k = client.result(jk)
        if "recon" not in ref or not np.array_equal(res_k, ref["recon"]):
            die("kill/resume: the survivor's result differs from the "
                "in-process run")
        st = client.stats()
        b_spans = spans(jb)
        report = {
            "workers": sorted(procs), "lease_ttl": REMOTE["lease_ttl"],
            "spool": spool,
            "a_nvcc_build_s": a_build_s,
            "b_prefetched": client.workers()["B"]["prefetched"],
            "b_prefetch_s": wall(sp for sp in b_spans
                                 if sp["name"] == "executable.prefetch"),
            "b_fetch_s": wall(sp for sp in b_spans if sp["name"] in (
                "executable.fetch", "executable.deserialize")),
            "b_load_s": wall(loads),
            "b_nvcc_runs": loads[0]["attrs"]["nvcc_runs"],
            # submission to the result on the broker, its clock
            "a_first_result_s": sa["finished_at"] - sa["submitted_at"],
            "b_first_result_s": sb["finished_at"] - sb["submitted_at"],
            "a_simulate_s": wall(spans(ja, "plugin.synthetic_tomo_loader"
                                           ".setup")),
            "b_simulate_s": wall(spans(jb, "plugin.synthetic_tomo_loader"
                                           ".setup")),
            "sweep": {"variants": len(cutoffs), "gang": len(cutoffs),
                      "wall_s": sweep_wall_s, "process_s": process_s,
                      "variants_per_s": len(cutoffs) / process_s,
                      "step_s": {sp["attrs"]["plugin"]:
                                 sp["end"] - sp["start"] for sp in proc},
                      "step_launches": one_each, "gang_fallbacks": 0,
                      "max_abs_err_vs_phase_3d": sweep_errs,
                      "bit_for_bit_vs_phase_3d": sweep_bitwise},
            "result_upload_mb": upload_mb,
            "result_upload_mb_per_s": upload_mb / wall(uploads),
            "b_vs_a_max_abs_err": 0.0,
            "kill": {"victim": victim, "survivor": snap_k["worker_id"],
                     "resumed_from": snap_k["resumed_from"],
                     "attempt": snap_k["attempt"],
                     "kill_to_done_s": resume_s,
                     "max_abs_err_vs_in_process": 0.0},
            "leases_expired": st["leases_expired"],
            "jobs_requeued": st["jobs_requeued"],
            "phase_s": time.perf_counter() - t_phase}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)
                p.kill()
            p.wait(timeout=60)
        for log in logs.values():
            log.close()
        svc.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def spans_of(spans: list, plugin: str) -> dict:
    """The process span of ``plugin`` among one job's process spans."""
    for sp in spans:
        if sp["name"] == f"plugin.{plugin}.process":
            return sp
    fail(f"no process span of {plugin}")


def jax_layout_params(cfg, rng) -> dict:
    """Random LM weights in the JAX package's parameter layout (numpy,
    leaves stacked over layers), for ``params_from_jax``."""
    d, hd, n = cfg.d_model, cfg.hd, cfg.n_layers

    def w(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(fan_in)))

    def scale():
        return 1 + 0.1 * rng.standard_normal((n, d), dtype=np.float32)

    tree = {"embed": w((cfg.vocab, d), d),
            "ln_f": 1 + 0.1 * rng.standard_normal(d, dtype=np.float32),
            "layers": ({
                "ln1": scale(), "ln2": scale(),
                "attn": {"wq": w((n, d, cfg.n_heads, hd), d),
                         "wk": w((n, d, cfg.n_kv_heads, hd), d),
                         "wv": w((n, d, cfg.n_kv_heads, hd), d),
                         "wo": w((n, cfg.n_heads, hd, d), cfg.n_heads * hd)},
                "mlp": {"w_up": w((n, d, cfg.d_ff), d),
                        "w_down": w((n, cfg.d_ff, d), cfg.d_ff),
                        "w_gate": w((n, d, cfg.d_ff), d)}},)}
    if not cfg.tie_embeddings:
        tree["unembed"] = w((cfg.vocab, d), d)
    return tree


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bp-slices", action="store_true",
                        help="phase 1 and the backprojection slice sweep "
                             "alone")
    args = parser.parse_args()
    try:
        import torch
        from torch.autograd import DeviceType
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 products in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.device import probe
    from repro_torch.kernels import build

    # -- 1. environment -------------------------------------------------
    info = probe()
    print(f"torch {info['torch']}  CUDA {info['cuda_version']}  "
          f"nvcc {info['nvcc']}  capability {info['capability']}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(smi)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build {build_s:.2f} s")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        print(log.read_text().strip())
    if args.bp_slices:
        print(json.dumps({"backprojection_slices_ms": bp_slice_sweep()}))
        return

    from repro_torch.configs import get_config
    from repro_torch.core import CudaTransport, PluginRunner
    from repro_torch.launch import pipeline_serve
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import (CheckpointStore, CompileCache, JobQueue,
                                     JobState, PipelineScheduler)
    from repro_torch.kernels.backproject.kernel import (
        backproject_cuda, rays_on_detector)
    from repro_torch.kernels.backproject.kernel import cost as bp_cost
    from repro_torch.kernels.backproject.ref import (backproject_ref,
                                                     backproject_tiled_ref)
    from repro_torch.kernels.correction.kernel import correct_cuda
    from repro_torch.kernels.correction.kernel import cost as corr_cost
    from repro_torch.kernels.correction.ref import (correct_batched_ref,
                                                    correct_ref)
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        cost as flash_cost
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import (mha_ref,
                                                         mha_tiled_ref)
    from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
    from repro_torch.kernels.sino_filter.kernel import cost as sf_cost
    from repro_torch.kernels.sino_filter.ops import filter_sino
    from repro_torch.kernels.sino_filter.ref import (
        filter_sino_batched_ref, filter_sino_ref, make_filter,
        scale_spectrum_batched_ref, scale_spectrum_ref)
    from repro_torch.models import build_model, transformer
    from repro_torch.models.convert import params_from_jax
    from repro_torch.tomo import (ParallelGeometry, phantom_stack,
                                  simulate_raw_scan, standard_chain)
    from repro_torch.training import (ContinuousBatcher, Request,
                                      make_serve_step)

    dev = torch.device("cuda")

    def compare(name, got, want, rtol, atol) -> float:
        got, want = got.double(), want.double()
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        if not torch.isfinite(got).all():
            fail(f"{name}: non-finite output")
        if bad.any():
            fail(f"{name}: {int(bad.sum())} of {bad.numel()} elements off "
                 f"(max abs err {float(err.max()):.3e}, rtol {rtol}, "
                 f"atol {atol})")
        return float(err.max())

    # -- 2. kernels against their plain versions --------------------------
    rows = []
    rng = np.random.default_rng(0)
    n_det, n_ang, n_rows = MAIN["n_det"], MAIN["n_angles"], MAIN["n_rows"]
    src = "src/repro_torch/kernels/csrc"

    raw = torch.from_numpy(rng.integers(
        50, 40000, size=(n_ang, n_rows, n_det), dtype=np.uint16)).to(dev)
    dark = torch.from_numpy(rng.integers(
        80, 120, size=(n_rows, n_det)).astype(np.float32)).to(dev)
    flat = torch.from_numpy(rng.integers(
        30000, 42000, size=(n_rows, n_det)).astype(np.float32)).to(dev)
    err = compare("correction", correct_cuda(raw, dark, flat),
                  correct_ref(raw, dark[None], flat[None]), 1e-6, 1e-6)
    compare("correction (float32 raw)",
            correct_cuda(raw[:8].float(), dark, flat),
            correct_ref(raw[:8].float(), dark[None], flat[None]),
            1e-6, 1e-6)
    dead = torch.full((n_rows, n_det), 100.0, device=dev)
    zeros = torch.from_numpy(np.zeros((1, n_rows, n_det), np.uint16)).to(dev)
    if not torch.isfinite(correct_cuda(zeros, dead, dead)).all():
        fail("correction: flat == dark gives non-finite output")
    b, by = work_bound(corr_cost(n_ang, n_rows * n_det, raw.element_size()))
    rows.append({
        "name": "correction", "route": "cuda",
        "source": f"{src}/correction.cu",
        "replaces": "src/repro/kernels/correction/kernel.py:33",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: correct_cuda(raw, dark, flat), 20),
        "plain_ms": cuda_ms(
            lambda: correct_ref(raw, dark[None], flat[None]), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    # one launch for a gang at the gang's shape: GANG["jobs"] members of
    # 1801 frames x 8 rows, each with its own dark and flat (the same
    # bytes as phase 3's scan); each member's output must equal that of
    # a launch for that member alone, bit for bit
    jobs = GANG["jobs"]
    braw = raw.reshape(n_ang, jobs, GANG["n_rows"], n_det).transpose(
        0, 1).contiguous().reshape(jobs * n_ang, GANG["n_rows"], n_det)
    bdark = dark.reshape(jobs, GANG["n_rows"], n_det).contiguous()
    bflat = flat.reshape(jobs, GANG["n_rows"], n_det).contiguous()
    counts = [n_ang] * jobs
    got = correct_cuda(braw, bdark, bflat, counts)
    berr = compare("correction, gang launch", got,
                   correct_batched_ref(braw, bdark, bflat, counts),
                   1e-6, 1e-6)
    for j in range(jobs):
        if not torch.equal(got[j * n_ang:(j + 1) * n_ang], correct_cuda(
                braw[j * n_ang:(j + 1) * n_ang], bdark[j], bflat[j])):
            fail(f"correction: member {j} of the gang launch differs from "
                 f"a launch for that member alone")
    rows[-1].update({
        "batched_shape": list(braw.shape), "batched_max_abs_err": berr,
        "batched_ms": cuda_ms(
            lambda: correct_cuda(braw, bdark, bflat, counts), 20),
        "batched_plain_ms": cuda_ms(
            lambda: correct_batched_ref(braw, bdark, bflat, counts), 10),
        "batched_bound_ms": work_bound(corr_cost(
            jobs * n_ang, GANG["n_rows"] * n_det, braw.element_size(),
            jobs))[0]})
    del raw, dark, flat, dead, zeros, braw, bdark, bflat, got

    filt_np = make_filter(n_det, "shepp")
    nf = filt_np.shape[0]
    n_fft = 2 * (nf - 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    sino = torch.randn((n_rows * n_ang, n_det), generator=gen, device=dev)
    filt = torch.from_numpy(filt_np).to(dev)
    spec = torch.fft.rfft(sino, n=n_fft, dim=-1)
    err = compare("spectrum scale",
                  torch.view_as_real(scale_spectrum_cuda(spec, filt)),
                  torch.view_as_real(scale_spectrum_ref(spec, filt)),
                  1e-5, 1e-5)
    compare("sino filter", filter_sino(sino, filt),
            filter_sino_ref(sino, filt), 1e-5, 1e-5)
    b, by = work_bound(sf_cost(*spec.shape))
    # the sweep of phase 3d at the same rows: 4 variants of 4 rows, one
    # filter row (cutoff) per variant, one launch; each member equal, bit
    # for bit, to the plain version and to a launch for it alone
    n_var = len(SWEEP["cutoffs"])
    nyq = torch.linspace(0.0, 1.0, nf, device=dev)
    filts = torch.stack([filt * (nyq <= c) for c in SWEEP["cutoffs"]])
    counts = [spec.shape[0] // n_var] * n_var
    got = scale_spectrum_cuda(spec, filts, counts)
    if not torch.equal(got, scale_spectrum_batched_ref(spec, filts, counts)):
        fail("spectrum scale, per-member launch: differs from "
             "scale_spectrum_batched_ref")
    for j, part in enumerate(torch.split(spec, counts)):
        if not torch.equal(got[j * counts[0]:(j + 1) * counts[0]],
                           scale_spectrum_cuda(part.contiguous(),
                                               filts[j])):
            fail(f"spectrum scale: member {j} of the per-member launch "
                 f"differs from a launch for that member alone")
    sweep_counts = [SWEEP["n_rows"]] * n_var
    berr = compare("sino filter, per-member launch",
                   filter_sino(sino.view(n_rows, n_ang, n_det), filts,
                               counts=sweep_counts),
                   filter_sino_batched_ref(sino.view(n_rows, n_ang, n_det),
                                           filts, sweep_counts),
                   1e-5, 1e-5)
    per_member = filts.view(n_var, 1, nf)
    # the kernel and `spec * filt` are within a few percent of each
    # other: time them in alternating rounds and keep every round's
    # median; the same for the per-member launch and its broadcast
    rounds = {"kernel": [], "library": [], "batched_kernel": [],
              "batched_library": []}
    for _ in range(SPECTRUM_ROUNDS):
        rounds["kernel"].append(
            cuda_ms(lambda: scale_spectrum_cuda(spec, filt), 20))
        rounds["library"].append(cuda_ms(lambda: spec * filt, 20))
        rounds["batched_kernel"].append(
            cuda_ms(lambda: scale_spectrum_cuda(spec, filts, counts), 20))
        rounds["batched_library"].append(cuda_ms(
            lambda: spec.view(n_var, -1, nf) * per_member, 20))
    print(json.dumps({"spectrum_scale_rounds_ms": rounds}))
    rows.append({
        "name": "spectrum_scale", "route": "cuda",
        "source": f"{src}/sino_filter.cu",
        "replaces": "src/repro/kernels/sino_filter/kernel.py:26",
        "max_abs_err": err,
        "ms": statistics.median(rounds["kernel"]),
        "plain_ms": cuda_ms(lambda: scale_spectrum_ref(spec, filt), 20),
        "bound_ms": b, "bound_by": by,
        "library_ms": statistics.median(rounds["library"]),
        "batched_shape": list(spec.shape), "batched_members": n_var,
        "batched_max_abs_err": berr,
        "batched_ms": statistics.median(rounds["batched_kernel"]),
        "batched_plain_ms": cuda_ms(
            lambda: scale_spectrum_batched_ref(spec, filts, counts), 20),
        "batched_bound_ms": work_bound(sf_cost(*spec.shape, n_var))[0],
        "batched_library_ms": statistics.median(
            rounds["batched_library"])})
    del sino, spec, got

    geom = ParallelGeometry(n_ang, n_det, n_rows)
    sino = torch.randn((n_rows, n_ang, n_det), generator=gen, device=dev)
    angles = torch.from_numpy(geom.angles.astype(np.float32)).to(dev)
    cos_t, sin_t = torch.cos(angles), torch.sin(angles)
    plain = backproject_ref(sino, angles, n_det)
    got = backproject_cuda(sino, cos_t, sin_t, n_det)
    err = compare("backprojection", got, plain, 2e-4, 2e-5)
    del plain
    tiled_err = compare(
        "backprojection against its own arithmetic (rows "
        f"{BP_TILED_ROWS})", got[:, BP_TILED_ROWS],
        backproject_tiled_ref(sino, angles, n_det, rows=BP_TILED_ROWS),
        *BP_TILED_TOL)
    del got
    # (pixel, angle) pairs whose ray lands on the detector, t in (-1, D)
    inside = rays_on_detector(cos_t, sin_t, n_det, n_det)
    updates = inside * n_rows
    bp_work = bp_cost(n_rows, n_ang, n_det, n_det, inside)
    b, by = work_bound(bp_work)
    rows.append({
        "name": "backprojection", "route": "cuda",
        "source": f"{src}/backproject.cu",
        "replaces": "src/repro/kernels/backproject/kernel.py:77",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: backproject_cuda(sino, cos_t, sin_t, n_det),
                      5),
        "plain_ms": cuda_ms(lambda: backproject_ref(sino, angles, n_det),
                            2, warmup=0),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    print(json.dumps({"backprojection": {
        "pairs_on_detector": inside, "updates": updates,
        "flops": bp_work["flops"],
        "bound_ms": b, "ms": rows[-1]["ms"],
        "g_updates_per_s": updates / rows[-1]["ms"] / 1e6,
        "max_abs_err_vs_tiled": tiled_err}}))
    del sino
    print(json.dumps({"backprojection_slices_ms": bp_slice_sweep()}))

    def qkv(shape, dtype):
        b_, hq, hkv, s_, d_ = shape
        return [torch.randn((b_, h, s_, d_), generator=gen, device=dev
                            ).to(dtype) for h in (hq, hkv, hkv)]

    q, k, v = qkv(FLASH_MAIN, torch.bfloat16)
    got = flash_attention_cuda(q, k, v)
    err = compare("flash attention (bf16, serving shape)", got,
                  mha_ref(q, k, v), *FLASH_BF16_TOL)
    tiled_err = compare("flash attention (bf16, serving shape) against "
                        "its tiled arithmetic", got, mha_tiled_ref(q, k, v),
                        *FLASH_TILED_TOL)
    del got
    for shape in FLASH_SWEEP:
        q32, k32, v32 = qkv(shape, torch.float32)
        for causal in (True, False):
            compare(f"flash attention (fp32, {shape}, causal={causal})",
                    flash_attention_cuda(q32, k32, v32, causal=causal),
                    mha_ref(q32, k32, v32, causal=causal), 2e-5, 2e-5)
    del q32, k32, v32
    flash_work = flash_cost(*FLASH_MAIN, q.element_size())
    flash_flops = flash_work["flops"]
    b, by = work_bound(flash_work, PEAK_BF16_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": f"{src}/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), 20),
        "plain_ms": cuda_ms(lambda: mha_ref(q, k, v), 5),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                           enable_gqa=True), 20)})
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(lambda: flash_attention_cuda(q32, k32, v32), 10)
    print(json.dumps({"flash_attention": {
        "shape": FLASH_MAIN, "bf16_ms": rows[-1]["ms"],
        "bf16_tflops": flash_flops / rows[-1]["ms"] / 1e9,
        "bf16_max_abs_err_vs_tiled": tiled_err,
        "fp32_ms": f32_ms, "fp32_tflops": flash_flops / f32_ms / 1e9}}))
    del q, k, v, q32, k32, v32
    torch.cuda.empty_cache()

    # -- 3. the tomography path --------------------------------------------
    wrappers = {"correction": correct_cuda,
                "spectrum_scale": scale_spectrum_cuda,
                "backprojection": backproject_cuda}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    # seed 0, as the loader would simulate it; phases 3b and 3c stream it
    scan = simulate_raw_scan(phantom_stack(n_det, n_rows),
                             ParallelGeometry(n_ang, n_det, n_rows),
                             seed=0, device=dev)
    simulate_s = time.perf_counter() - t0
    chain = standard_chain(**MAIN)
    chain.entries[0].params["scan"] = scan
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    runner = PluginRunner(chain)
    out = runner.run()
    torch.cuda.synchronize(dev)
    chain_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for row in rows:
        row["launches"] = launches.get(row["name"])
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path launched no {missing} kernel")
    recon3 = recon = out["recon"].backing
    if not isinstance(recon, torch.Tensor) or recon.device.type != "cuda":
        fail(f"recon is not a CUDA tensor: {type(recon)}")
    want = (n_rows, n_det, n_det)
    if tuple(recon.shape) != want or not torch.isfinite(recon).all():
        fail(f"recon shape {tuple(recon.shape)} (want {want}) or "
             f"non-finite values")
    truth = torch.from_numpy(out["recon"].metadata["truth"]).to(dev)
    crop = (slice(None), slice(8, -8), slice(8, -8))
    corr = float(torch.corrcoef(torch.stack(
        [truth[crop].reshape(-1).double(),
         recon[crop].reshape(-1).double()]))[0, 1])
    peak = torch.cuda.max_memory_allocated(dev)
    print(json.dumps({
        "chain": MAIN, "wall_s": chain_s, "simulate_s": simulate_s,
        "process_s": runner.profiler.totals("process"),
        "max_memory_allocated": peak, "phantom_corr": corr,
        "launches": launches}))
    if not corr > 0.85:
        fail(f"phantom correlation {corr:.4f} <= 0.85")
    del out, runner, truth
    torch.cuda.empty_cache()

    # -- 3a. the service: a gang of jobs through pipeline_serve -----------
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    gang = pipeline_serve.main([
        "--jobs", str(GANG["jobs"]), "--workers", "1", "--batch",
        "--n-det", str(n_det), "--n-angles", str(n_ang),
        "--n-rows", str(GANG["n_rows"]), "--verify"])
    total = {k: w.launches for k, w in wrappers.items()}
    if gang["gangs_run"] != 1:
        fail(f"gang: {gang['gangs_run']} gangs ran, expected 1")
    if gang["kernel_launches"] != {k: 1 for k in wrappers}:
        fail(f"gang: kernel launches over the gang's steps "
             f"{gang['kernel_launches']}, expected one of each")
    # one more of each per serial verification run
    if total != {k: 1 + GANG["jobs"] for k in wrappers}:
        fail(f"gang: kernel launches with the verification {total}")
    if gang["gang_fallbacks"]:
        fail(f"gang: {gang['gang_fallbacks']} steps fell back to solo")
    print(json.dumps({"service_gang": {
        "jobs": GANG["jobs"], "n_rows_per_job": GANG["n_rows"],
        # the service's throughput: jobs over the time some job was in a
        # plugin step (the gang's steps)
        "jobs_per_s": gang["process_jobs_per_s"],
        "process_s": gang["process_s"], "step_s": gang["step_s"],
        # start to drain, each job's loader simulating its scan included
        "jobs_per_s_with_simulation": gang["jobs_per_s"],
        "wall_s_with_simulation": gang["wall_s"],
        "job_wall_s_with_simulation": gang["job_wall_s"],
        "max_abs_err_vs_serial": gang["max_abs_err_vs_serial"],
        "compile_cache": gang["compile_cache"],
        "launches": gang["kernel_launches"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}}))
    torch.cuda.empty_cache()

    # -- 3b. streaming: phase 3's scan arriving slab by slab --------------
    frames = scan["data"]                      # host uint16, as acquired

    def slab_bounds(lo_hi, start=0):
        rng_s = np.random.default_rng(0)
        bounds, at = [], start
        while at < n_ang:
            k = int(rng_s.integers(lo_hi[0], lo_hi[1] + 1))
            bounds.append((at, min(n_ang, at + k)))
            at += k
        return bounds

    def streaming_job(queue):
        chain = standard_chain(**MAIN)
        chain.entries[0].params["scan"] = scan
        chain.streaming = True
        return queue.submit(chain, job_id="scan-0")

    def wait_for(cond, what):
        t_end = time.perf_counter() + STREAM_WAIT_S
        while not cond():
            if job.state.terminal() and not cond():
                fail(f"{what}: job ended {job.status}: "
                     f"{job.metadata.get('traceback', '')}")
            if time.perf_counter() > t_end:
                fail(f"{what}: timed out ({job.snapshot()})")
            time.sleep(0.002)

    def same_as_phase3(job, what):
        got = job.runner.datasets["recon"].backing
        if not torch.equal(got, recon3):
            fail(f"{what}: reconstruction differs from phase 3's (max abs "
                 f"err {float((got - recon3).abs().max()):.3e})")

    cache = CompileCache()
    metrics = MetricsRegistry()
    queue = JobQueue()
    sched = PipelineScheduler(
        queue, n_workers=1, metrics=metrics, compile_cache=cache,
        transport_factory=lambda j: CudaTransport(dev, compile_cache=cache))
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    job = streaming_job(queue)
    sched.start()
    preview = None
    bounds = slab_bounds(STREAM_SLABS)
    try:
        t0 = time.perf_counter()
        for lo, hi in bounds:
            last_append = time.time()
            sched.ingest_frames(job.job_id, frames[lo:hi], lo)
            if hi < n_ang:
                wait_for(lambda: job.frames_consumed >= hi, "streaming")
            if preview is None and hi >= n_ang // 2:
                torch.cuda.synchronize(dev)
                tp = time.perf_counter()
                arr, cut = sched.preview(job.job_id)
                preview = {"watermark": cut,
                           "ms": (time.perf_counter() - tp) * 1e3,
                           "finite": bool(np.isfinite(arr).all()),
                           "shape": list(arr.shape)}
                del arr
        sched.mark_eof(job.job_id)
        if not sched.drain(timeout=STREAM_WAIT_S):
            fail(f"streaming: job not done ({job.snapshot()})")
        stream_s = time.perf_counter() - t0
    finally:
        sched.shutdown()
    if job.state is not JobState.DONE:
        fail(f"streaming: {job.status}\n{job.metadata.get('traceback')}")
    same_as_phase3(job, "streaming")
    snap = metrics.snapshot()
    pumps = snap["stream.window_latency_s"]["count"]
    slaunch = {k: w.launches for k, w in wrappers.items()}
    if slaunch["correction"] != pumps or pumps != len(bounds):
        fail(f"streaming: {slaunch['correction']} correction launches, "
             f"{pumps} pumps, {len(bounds)} slabs")
    # the preview and the final tail: the rest of the chain twice each
    if slaunch["spectrum_scale"] != 2 or slaunch["backprojection"] != 2:
        fail(f"streaming: launches {slaunch}, expected 2 spectrum scale and "
             f"2 backprojection (the preview and the tail)")
    if not (preview and preview["finite"]
            and 0 < preview["watermark"] <= n_ang
            and preview["shape"] == [n_rows, n_det, n_det]):
        fail(f"streaming: preview {preview}")
    print(json.dumps({"streaming": {
        "slabs": len(bounds), "slab_frames": list(STREAM_SLABS),
        "pumps": pumps, "launches": slaunch, "wall_s": stream_s,
        "window_latency_s": snap["stream.window_latency_s"],
        "ingest_lag_s": snap["stream.ingest_lag_s"],
        "preview": preview,
        "last_frame_to_done_s": job.finished_at - last_append,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}}))
    del job, sched
    torch.cuda.empty_cache()

    # -- 3c. resume: a checkpointed stream killed half way ----------------
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        store = CheckpointStore(ckpt_dir)
        saves = []
        store_save = store.save

        def counted_save(job_id, runner):
            st = store_save(job_id, runner)
            saves.append(st)
            return st

        store.save = counted_save
        bounds = slab_bounds(RESUME_SLABS)
        half = next(hi for _, hi in bounds if hi >= n_ang // 2)
        runs = []
        for attempt in range(2):
            queue = JobQueue()
            sched = PipelineScheduler(
                queue, n_workers=1, checkpoints=store, compile_cache=cache,
                transport_factory=lambda j: CudaTransport(
                    dev, compile_cache=cache))
            job = streaming_job(queue)
            runs.append(job)
            sched.start()
            try:
                # each slab once the previous one is checkpointed
                if attempt == 0:
                    feed = [(lo, hi) for lo, hi in bounds if lo < half]
                else:
                    restored = store.load(job.job_id)["stream"]["ingested"]
                    feed = slab_bounds(RESUME_SLABS, restored)
                for lo, hi in feed:
                    sched.ingest_frames(job.job_id, frames[lo:hi], lo)
                    if hi < n_ang:
                        wait_for(lambda: (store.load(job.job_id) or {}).get(
                            "stream", {}).get("ingested") == hi,
                            f"resume: checkpoint at frame {hi}")
                if attempt == 1:
                    sched.mark_eof(job.job_id)
                    if not sched.drain(timeout=STREAM_WAIT_S):
                        fail(f"resume: job not done ({job.snapshot()})")
            finally:
                sched.shutdown()
        first, second = runs
        if restored != half:
            fail(f"resume: restored at frame {restored}, the first run's "
                 f"last checkpoint holds {half}")
        if first.state is not JobState.FAILED or \
                "mid-stream" not in (first.error or ""):
            fail(f"resume: the first run ended {first.status}")
        if second.state is not JobState.DONE:
            fail(f"resume: {second.status}\n"
                 f"{second.metadata.get('traceback')}")
        same_as_phase3(second, "resume")
        save_s = [sp.wall for j in runs for sp in j.trace.spans()
                  if sp.name == "checkpoint.save"]
        print(json.dumps({"stream_resume": {
            "slab_frames": list(RESUME_SLABS), "restored_watermark": restored,
            "checkpoint_saves": len(save_s),
            "checkpoint_save_s": save_s,
            "checkpoint_save_s_median": statistics.median(save_s),
            "bytes_written": sum(st["bytes_written"] for st in saves),
            "bytes_written_per_save": [st["bytes_written"] for st in saves],
            "checkpoint_cleared": store.load(second.job_id) is None}}))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del runs, first, second, job, sched, recon3, frames, scan
    torch.cuda.empty_cache()

    # -- 3d. the HTTP service on the card: a sweep, a workflow, telemetry
    http_report, sweep_result = http_service_phase(
        dev, compare, wrappers,
        costs={"correction": corr_cost, "spectrum_scale": sf_cost,
               "backprojection": bp_cost},
        rays_on_detector=rays_on_detector)
    print(json.dumps({"http_service": http_report}))
    torch.cuda.empty_cache()

    # -- 3e. remote workers: a broker and worker processes on the card
    print(json.dumps({"remote_workers": remote_workers_phase(
        dev, sweep_result)}), flush=True)
    del sweep_result

    # -- 4. chain parity: kernels on the card vs plain versions on the CPU
    pgeom = ParallelGeometry(PARITY["n_angles"], PARITY["n_det"],
                             PARITY["n_rows"])
    scan = simulate_raw_scan(phantom_stack(PARITY["n_det"],
                                           PARITY["n_rows"]), pgeom)

    def run_chain(device: str) -> np.ndarray:
        chain = standard_chain(**PARITY, device=device)
        chain.entries[0].params["scan"] = scan
        r = PluginRunner(chain, CudaTransport(device))
        return r.transport.read(r.run()["recon"])

    on_card, on_cpu = run_chain("cuda"), run_chain("cpu")
    perr = float(np.abs(on_card - on_cpu).max())
    if not np.allclose(on_card, on_cpu, rtol=1e-3, atol=1e-4):
        fail(f"chain parity: card vs CPU max abs err {perr:.3e} "
             f"(rtol 1e-3, atol 1e-4)")
    print(f"chain parity {PARITY}: max abs err card vs CPU {perr:.3e}")

    # -- 5. the serving path: granite-8b at full width ---------------------
    cfg = dataclasses.replace(get_config(SERVE["arch"]), use_flash=True)
    model = build_model(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    prefill_ms, decode_ms, first_token_s = [], [], []

    def timed(fn, times, marks=None):
        """``fn`` synchronised and timed; counts non-finite logits."""
        def call(*args):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
            if marks is not None:
                marks.append(time.perf_counter() - run_t0)
            nonfinite.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return call

    served = dataclasses.replace(
        model, prefill=timed(model.prefill, prefill_ms, first_token_s),
        decode_step=timed(model.decode_step, decode_ms))
    batcher = ContinuousBatcher(served, params, slots=SERVE["slots"],
                                max_len=SERVE["max_len"])
    rng = np.random.default_rng(0)
    for i in range(SERVE["requests"]):
        batcher.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, (SERVE["prompt_len"],)
                                       ).astype(np.int32),
            max_new=SERVE["max_new"]))
    flash_attention_cuda.launches = 0
    run_t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - run_t0
    flash_launches = flash_attention_cuda.launches
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches"] = flash_launches
    n_tokens = sum(len(r.generated) for r in done)
    print(json.dumps({
        "serve": SERVE, "init_s": init_s, "wall_s": serve_s,
        "prefill_ms": prefill_ms,
        "prefill_ms_median": statistics.median(prefill_ms),
        "first_token_s": first_token_s,
        "decode_steps": len(decode_ms),
        "decode_step_ms_median": statistics.median(decode_ms),
        "decode_step_ms_max": max(decode_ms),
        "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": {"flash_attention": flash_launches}}))
    want_launches = SERVE["requests"] * cfg.n_layers
    if flash_launches != want_launches:
        fail(f"serving launched the flash kernel {flash_launches} times, "
             f"expected {want_launches}")
    if sorted(r.rid for r in done) != list(range(SERVE["requests"])):
        fail(f"served {sorted(r.rid for r in done)}")
    for r in done:
        if len(r.generated) != SERVE["max_new"] or not all(
                0 <= t < cfg.vocab for t in r.generated):
            fail(f"request {r.rid}: {len(r.generated)} tokens, some "
                 f"outside [0, {cfg.vocab})")
    if int(nonfinite):
        fail(f"{int(nonfinite)} non-finite logits while serving")
    # where a decode step's time goes: kernel time on the card against the
    # wall, over a few steps of a fresh batch (a step attends over all
    # max_len slots whatever the length, so each costs the same)
    step = make_serve_step(model)
    cache = model.init_cache(SERVE["slots"], SERVE["max_len"])
    tok = torch.zeros((SERVE["slots"], 1), dtype=torch.int32, device=dev)
    for _ in range(2):
        tok, cache = step(params, tok, cache)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            tok, cache = step(params, tok, cache)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    stats = prof.key_averages()
    # kernel time counted once: on the device's own events, not again
    # under the CPU ops that launched them
    busy_ms = sum(e.self_device_time_total for e in stats
                  if e.device_type == DeviceType.CUDA) / 1e3 / PROFILED_STEPS
    launches_per_step = sum(e.count for e in stats if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
        "cudaLaunchKernelExC")) / PROFILED_STEPS
    step_ms = statistics.median(decode_ms)
    print(json.dumps({"decode_profile": {
        "steps": PROFILED_STEPS, "profiled_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share_of_serving_step": (1 - busy_ms / step_ms
                                       if busy_ms else None),
        "kernel_launches_per_step": launches_per_step}}))
    del model, served, batcher, params, done, cache, prof
    torch.cuda.empty_cache()

    # -- 6. LM parity ---------------------------------------------------
    cfg = dataclasses.replace(get_config(SERVE["arch"], smoke=True),
                              use_flash=True)
    tree = jax_layout_params(cfg, np.random.default_rng(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (5, 24))
    runs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device)
        logits = []

        def prefill(params, batch, max_len, model=model, logits=logits):
            out, cache = model.prefill(params, batch, max_len)
            logits.append(out.cpu())
            return out, cache

        batcher = ContinuousBatcher(
            dataclasses.replace(model, prefill=prefill),
            params_from_jax(tree, cfg, device), slots=2, max_len=40)
        for i, p in enumerate(prompts):
            batcher.submit(Request(rid=i, prompt=p, max_new=8))
        flash_attention_cuda.launches = 0
        tokens = {r.rid: r.generated for r in batcher.run()}
        runs[device] = (tokens, torch.cat(logits),
                        flash_attention_cuda.launches)
    (card_toks, card_logits, n_card), (cpu_toks, cpu_logits, n_cpu) = \
        runs["cuda"], runs["cpu"]
    if (n_card, n_cpu) != (5 * cfg.n_layers, 0):
        fail(f"LM parity: {n_card} kernel launches on the card, {n_cpu} "
             f"on the CPU")
    if card_toks != cpu_toks:
        fail(f"LM parity: tokens differ, card {card_toks} cpu {cpu_toks}")
    lm_err = compare("LM parity: smoke prefill logits, card vs CPU",
                     card_logits, cpu_logits, 2e-4, 2e-4)
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2,
                              dtype=torch.float32)
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": np.random.default_rng(2).integers(
        0, cfg.vocab, (1, SERVE["prompt_len"]))}
    wide = [build_model(dataclasses.replace(cfg, use_flash=f), dev).prefill(
        params, batch, SERVE["prompt_len"])[0] for f in (True, False)]
    wide_err = compare("LM parity: full width, 2 layers, fp32, kernel vs "
                       "plain", wide[0], wide[1], 2e-4, 2e-4)
    del params, wide
    # bf16, the serving dtype: block weights stored in bf16; the fp32
    # plain path upcasts the same weights at use
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(1))
    kernel_bf16, plain_bf16, plain_fp32 = (
        build_model(dataclasses.replace(cfg, use_flash=f, dtype=dt),
                    dev).prefill(params, batch, SERVE["prompt_len"])[0]
        .double()
        for f, dt in ((True, torch.bfloat16), (False, torch.bfloat16),
                      (False, torch.float32)))
    rounding = float((plain_bf16 - plain_fp32).abs().max())
    wide_bf16_err = float((kernel_bf16 - plain_bf16).abs().max())
    if not (torch.isfinite(kernel_bf16).all() and wide_bf16_err <= rounding):
        fail(f"LM parity: full width, 2 layers, bf16: kernel vs plain max "
             f"abs err {wide_bf16_err:.3e} exceeds the bf16 rounding of "
             f"the plain path ({rounding:.3e} against fp32)")
    print(f"LM parity: smoke tokens identical over 5 requests, prefill "
          f"logits max abs err {lm_err:.3e}; full width 2 layers fp32 "
          f"{wide_err:.3e}; bf16 kernel vs plain {wide_bf16_err:.3e} "
          f"(bf16 rounding, plain bf16 vs fp32: {rounding:.3e})")
    # how strong that check is: the distance it reads with a planted
    # fault in the prefill's attention, against the same limit
    def v_last_tile_zeroed(q, k, v, *, causal, use_pallas):
        """the kernel with the last 64-key V tile zero-filled, as a wrong
        cp.async src-size would leave it"""
        v = v.clone(memory_format=torch.contiguous_format)
        v[:, :, -64:] = 0
        return attention(q, k, v, causal=causal, use_pallas=use_pallas)

    def p_rounded(q, k, v, *, causal, use_pallas):
        """the kernel's tiled arithmetic with P rounded to bf16, not split"""
        with mock.patch.object(flash_ref, "_split_p", lambda p: (
                p.to(torch.bfloat16).float(), torch.zeros_like(p))):
            return mha_tiled_ref(q, k, v, causal=causal)

    flash_model = build_model(dataclasses.replace(cfg, use_flash=True), dev)
    planted = {}
    for name, fault in (("v_last_tile_zeroed", v_last_tile_zeroed),
                        ("p_rounded", p_rounded)):
        with mock.patch.object(transformer, "flash_attention", fault):
            got = flash_model.prefill(params, batch, SERVE["prompt_len"])[0]
        planted[name] = float((got.double() - plain_bf16).abs().max())
    print(json.dumps({"bf16_check_planted_faults": {
        "limit": rounding, "kernel": wide_bf16_err, **{
            k: {"max_abs_err": e, "caught": e > rounding}
            for k, e in planted.items()}}}))
    del params, kernel_bf16, plain_bf16, plain_fp32, flash_model, got

    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: v for k, v in r.items() if k.startswith("batched_")}}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
