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
   spectrum scale and ``spec * filt`` in alternating rounds).  Flash
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
   (pixel, angle), lerps per slice), its bound beside the earlier
   count's and its achieved G updates/s; another gives its time at the
   main geometry for 1 to 16 slices through the entry point and with
   each group size of slices a block may own, which must all give the
   entry point's output bit for bit;
3. the tomography path: ``standard_chain(n_det=2560, n_angles=1801,
   n_rows=16)`` through ``PluginRunner`` on ``CudaTransport("cuda")``
   with every kernel's launch count set to 0 just before; checks that
   every kernel launched and that the reconstruction matches the
   phantom (correlation > 0.85 over the [8:-8] crop);
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

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
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
import statistics
import subprocess
import sys
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
#: least fp32 work of backprojection: all slices share the geometry, so
#: the position step and the fraction (2) count once per (pixel, angle)
#: whose ray lands on the detector, and the lerp a + f(b - a) (3, the
#: multiply-add counted as 2) and the accumulation (1) once per slice
BP_FLOPS_PER_PAIR = 2
BP_FLOPS_PER_UPDATE = 4
#: the earlier count, all 6 per slice, printed beside the new bound
BP_FLOPS_PER_UPDATE_EARLIER = 6
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
    from repro_torch.kernels.backproject.kernel import backproject_cuda
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
    from repro_torch.kernels.backproject.kernel import backproject_cuda
    from repro_torch.kernels.backproject.ref import (backproject_ref,
                                                     backproject_tiled_ref)
    from repro_torch.kernels.correction.kernel import correct_cuda
    from repro_torch.kernels.correction.ref import correct_ref
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import (mha_ref,
                                                         mha_tiled_ref)
    from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
    from repro_torch.kernels.sino_filter.ops import filter_sino
    from repro_torch.kernels.sino_filter.ref import (filter_sino_ref,
                                                     make_filter,
                                                     scale_spectrum_ref)
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
    # the kernel and `spec * filt` are within a few percent of each
    # other: time them in alternating rounds and keep every round's median
    rounds = {"kernel": [], "library": []}
    for _ in range(SPECTRUM_ROUNDS):
        rounds["kernel"].append(
            cuda_ms(lambda: scale_spectrum_cuda(spec, filt), 20))
        rounds["library"].append(cuda_ms(lambda: spec * filt, 20))
    print(json.dumps({"spectrum_scale_rounds_ms": rounds}))
    rows.append({
        "name": "spectrum_scale", "route": "cuda",
        "source": f"{src}/sino_filter.cu",
        "replaces": "src/repro/kernels/sino_filter/kernel.py:26",
        "max_abs_err": err,
        "ms": statistics.median(rounds["kernel"]),
        "plain_ms": cuda_ms(lambda: scale_spectrum_ref(spec, filt), 20),
        "bound_ms": b, "bound_by": by,
        "library_ms": statistics.median(rounds["library"])})
    del sino, spec

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
    bp_bytes = sino.numel() * 4 + n_rows * n_det * n_det * 4 + 2 * n_ang * 4
    bp_flops = inside * BP_FLOPS_PER_PAIR + updates * BP_FLOPS_PER_UPDATE
    b, by = bound_ms(bp_bytes, bp_flops)
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
        "pairs_on_detector": inside, "updates": updates, "flops": bp_flops,
        "bound_ms": b,
        "bound_ms_earlier_count": bound_ms(
            bp_bytes, updates * BP_FLOPS_PER_UPDATE_EARLIER)[0],
        "ms": rows[-1]["ms"],
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
    fb, fhq, _, fs, fd = FLASH_MAIN
    # each input read once and the output written once; causal pairs
    # (r, c <= r) cost 2D operations for q.k and 2D for p.v
    flash_flops = 4 * fb * fhq * fd * fs * (fs + 1) / 2
    b, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                     flash_flops, PEAK_BF16_FLOPS)
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
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    runner = PluginRunner(standard_chain(**MAIN))
    out = runner.run()
    torch.cuda.synchronize(dev)
    chain_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for row in rows:
        row["launches"] = launches.get(row["name"])
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
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
