#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: torch/CUDA versions, the nvcc path, the card's name and
   power limit (nvidia-smi); builds the CUDA kernels and times the build;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes, with the tolerances of the
   JAX package's kernel tests; times the kernel, the plain version and,
   where one PyTorch call computes the same function, that call;
3. the main path: ``standard_chain(n_det=2560, n_angles=1801,
   n_rows=16)`` through ``PluginRunner`` on ``CudaTransport("cuda")``
   with every kernel's launch count set to 0 just before; checks that
   every kernel launched and that the reconstruction matches the
   phantom (correlation > 0.85 over the [8:-8] crop);
4. chain parity: one small scan through the chain on the card with the
   kernels and on the CPU with the plain versions (rtol 1e-3, atol 1e-4).

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: the main path: PCO.edge 5.5 width (2560 columns), a 180° scan of 1801
#: projections; rows cut from the detector's 2160 to 16
MAIN = {"n_det": 2560, "n_angles": 1801, "n_rows": 16}
PARITY = {"n_det": 256, "n_angles": 256, "n_rows": 2}
#: fp32 operations per (pixel, angle) backprojection update: the
#: position step (1), the fraction (1), the lerp a + f(b - a) (3, the
#: multiply-add counted as 2) and the accumulation (1)
BP_FLOPS_PER_UPDATE = 6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or fp32
    operations over the peak rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    from repro_torch.core import CudaTransport, PluginRunner
    from repro_torch.device import probe
    from repro_torch.kernels import build
    from repro_torch.kernels.backproject.kernel import backproject_cuda
    from repro_torch.kernels.backproject.ref import backproject_ref
    from repro_torch.kernels.correction.kernel import correct_cuda
    from repro_torch.kernels.correction.ref import correct_ref
    from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
    from repro_torch.kernels.sino_filter.ops import filter_sino
    from repro_torch.kernels.sino_filter.ref import (filter_sino_ref,
                                                     make_filter,
                                                     scale_spectrum_ref)
    from repro_torch.tomo import (ParallelGeometry, phantom_stack,
                                  simulate_raw_scan, standard_chain)

    dev = torch.device("cuda")

    def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
        """Median device time of ``fn`` in ms, by CUDA events."""
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
    # per pixel: two subtractions, a division, three clamps and a log
    b, by = bound_ms(raw.numel() * (2 + 4) + 2 * dark.numel() * 4,
                     raw.numel() * 7)
    rows.append({
        "name": "correction", "route": "cuda",
        "source": f"{src}/correction.cu",
        "replaces": "src/repro/kernels/correction/kernel.py:33",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: correct_cuda(raw, dark, flat), 20),
        "plain_ms": cuda_ms(
            lambda: correct_ref(raw, dark[None], flat[None]), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    del raw, dark, flat, dead, zeros

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
    b, by = bound_ms(spec.numel() * 8 * 2 + nf * 4, spec.numel() * 2)
    rows.append({
        "name": "spectrum_scale", "route": "cuda",
        "source": f"{src}/sino_filter.cu",
        "replaces": "src/repro/kernels/sino_filter/kernel.py:26",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: scale_spectrum_cuda(spec, filt), 20),
        "plain_ms": cuda_ms(lambda: scale_spectrum_ref(spec, filt), 20),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: spec * filt, 20)})
    del sino, spec

    geom = ParallelGeometry(n_ang, n_det, n_rows)
    sino = torch.randn((n_rows, n_ang, n_det), generator=gen, device=dev)
    angles = torch.from_numpy(geom.angles.astype(np.float32)).to(dev)
    cos_t, sin_t = torch.cos(angles), torch.sin(angles)
    plain = backproject_ref(sino, angles, n_det)
    err = compare("backprojection",
                  backproject_cuda(sino, cos_t, sin_t, n_det), plain,
                  2e-4, 2e-5)
    del plain
    # (pixel, angle) pairs whose ray lands on the detector, t in (-1, D);
    # out_size == n_det, so the image centre c is also the detector centre
    c = (n_det - 1) / 2.0
    xs = torch.arange(n_det, dtype=torch.float32, device=dev) - c
    inside = 0
    for a0 in range(0, n_ang, 8):
        t = (xs[None, None, :] * cos_t[a0:a0 + 8, None, None]
             + xs[None, :, None] * sin_t[a0:a0 + 8, None, None] + c)
        inside += int(((t > -1.0) & (t < n_det)).sum())
    del t
    updates = inside * n_rows
    b, by = bound_ms(sino.numel() * 4 + n_rows * n_det * n_det * 4
                     + 2 * n_ang * 4, updates * BP_FLOPS_PER_UPDATE)
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
    print(f"backprojection updates in this run: {updates} "
          f"({BP_FLOPS_PER_UPDATE} fp32 operations each)")
    del sino
    torch.cuda.empty_cache()

    # -- 3. the main path --------------------------------------------------
    wrappers = {"correction": correct_cuda,
                "spectrum_scale": scale_spectrum_cuda,
                "backprojection": backproject_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    runner = PluginRunner(standard_chain(**MAIN))
    out = runner.run()
    torch.cuda.synchronize(dev)
    chain_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for row in rows:
        row["launches"] = launches[row["name"]]
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path launched no {missing} kernel")
    recon = out["recon"].backing
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
        "chain": MAIN, "wall_s": chain_s,
        "simulate_s": runner.profiler.totals("setup").get(
            "synthetic_tomo_loader"),
        "process_s": runner.profiler.totals("process"),
        "max_memory_allocated": peak, "phantom_corr": corr,
        "launches": launches}))
    if not corr > 0.85:
        fail(f"phantom correlation {corr:.4f} <= 0.85")
    del out, runner, recon, truth
    torch.cuda.empty_cache()

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

    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
