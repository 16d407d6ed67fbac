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
   achieved TFLOP/s.  At every prefill attention shape of phase 7's
   traffic (``flash_family_shapes``: qwen3-moe, llava-next and zamba2's
   causal prefills; whisper-small's non-causal encoder over 1500 frames,
   causal decoder and cross-attention of 4 tokens against 1500 frames)
   the kernel is held against ``mha_ref`` in bf16 and fp32 and timed
   beside its bound, the plain version and
   ``scaled_dot_product_attention``.  Backprojection is
   also held, on four full image rows, against ``backproject_tiled_ref``,
   which repeats its arithmetic
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
   in the kernel's tiled arithmetic), against its limit;
7. the other families at full width (bf16, random weights from seed 0,
   ``use_flash``), each model freed before the next, as their users
   call them: qwen3-moe-235b-a22b (8 of 94 layers) through
   ``ContinuousBatcher``, 4 requests x 1024 prompt tokens, 32 new, 4
   slots; llava-next-34b (all 60 layers) through ``greedy_generate``,
   batch 2 of 2048 patch embeddings + 64 tokens, 32 new; zamba2-1.2b
   through ``ContinuousBatcher``, 4 x 2048 tokens, 64 new, 4 slots;
   xlstm-1.3b through ``ContinuousBatcher``, 4 x 512 tokens, 32 new, 2
   slots; whisper-small through ``greedy_generate``, batch 4 of 1500
   frames + 4 tokens, 64 new.  The flash kernel's count is set to 0
   just before each run and must read one prefill's launches per prompt
   (32, 60, 24, 0, 36); every logit finite, every token in the
   vocabulary; then a few decode steps of a fresh cache under
   ``torch.profiler`` (device busy time against the wall, top kernels).
   qwen3-moe is served a second time on the same weights with the same
   traffic through the grouped MoE dispatch (``moe_grouped``; one card
   is one group): its prefill and decode medians beside the flat run's,
   its first prefill's logits within ``GROUPED_LOGITS_ATOL`` of the flat
   run's;
8. family parity: the six smoke configurations of those families
   (fp32, llama4-maverick's dense/MoE interleave and shared expert
   included), and qwen3-moe's and llama4's with the grouped dispatch at
   1, 2 and 4 groups (the group count pinned through
   ``moe._dp_extent``), through ``greedy_generate`` with the kernel on
   the card and with the plain versions on the CPU, on the same
   weights: identical tokens, prefill logits within 2e-4.  Then one MoE
   layer at qwen3-moe's full widths (d 4096, 128 experts, top 8, f
   1536, bf16, x (4, 1024, 4096), seed 0): the grouped dispatch at 4
   groups must equal the flat dispatch applied to each group's tokens
   on its own within rtol 1e-2 and atol 1e-3, and its aux the flat aux;
   the largest difference and the CUDA-event times of both;
9. training, through the entry points a trainer calls
   (``build_model(cfg, training=True)``, ``init_training``,
   ``make_train_step``, ``token_stream``, ``launch.train``); no kernel
   of the port is on this path (the reference trains with
   ``use_flash=False``):
   a. granite-8b ``FULL`` at full width (fp32 weights, bf16 compute,
      random weights from seed 0) at the repo's ``train_4k`` shape, seq
      4096, the global batch cut from 256 to 8 in 8 microbatch chunks,
      remat 'dots', fp32 moments; the depth is what fits the free
      memory by a byte count made before the run (``train_depth``,
      printed as ``{"train_depth": ...}``).  1 warm-up and 2 timed steps
      on one repeated batch (the loss must fall): step ms, tokens/s, MFU
      (6·N·tokens / step / 989e12, N without the input table), peak
      memory net of what was resident; one step under
      ``torch.profiler`` (device busy share, top kernels); then 1 step
      with remat 'nothing' and 1 with int8 moments (quantised from the
      fp32 ones), each peaking lower than 'dots' with fp32 moments, the
      measured differences beside the predicted ones (one step sets a
      run's peak; the steps of a run spread by 0.3 %);
   b. every architecture's smoke config: 2 train steps on the card and
      on the CPU from the same weights and batch (loss and grad norm
      within rtol 1e-4; updated leaves within ``train_parity_phase``'s
      bounds), MoE's scatter and the sLSTM loop on the card;
   c. ``python -m repro_torch.launch.train`` (dense smoke, on the card)
      run uninterrupted and, beside it, run again SIGKILLed once
      ``step_19`` is published and restarted: it resumes at step 20, and
      its final checkpoint must equal the uninterrupted run's bit for
      bit.
10. the distributed modules and the roofline (``{"compression": ...}``,
    ``{"roofline": ...}`` and ``{"dryrun": ...}`` lines, each with the
    card's name and power limit):
   a. ``distributed.compressed_psum`` over a one-rank NCCL group
      (``init_device_mesh("cuda", (1,), ("pod",))``) on a (4096, 14336)
      fp32 tensor, granite-8b's ``w_up``: it must equal quantise →
      dequantise on the card and on the CPU bit for bit; its time by
      CUDA events;
   b. ``roofline.Counter`` around granite-8b FULL's prefill of one
      2048-token request (the flash kernel launched, its work through
      its ``cost()``) and around phase 3's chain on phase 3's scan (the
      three tomography kernels launched): counted flops and bytes,
      ``compute_s``, ``memory_s``, the bottleneck, the measured time
      (host clock, synchronised, median of 3) and measured / bound.
      The prefill's counted flops must be within 1 % of its products
      (``launch.dryrun.model_flops``: 2·N·T with N without the tables,
      plus the last position's logits) plus the flash kernel's
      ``cost()`` flops, else the phase fails;
   c. on the host: ``launch.dryrun.ladder`` for granite-8b ``train_4k``
      on the fake 16 x 16 mesh, depth cut to ``DRYRUN_DEPTH`` of 36
      (each layer costs ~14 s of tracing), and ``launch.dryrun_tomo``
      at 3072 x 2048 x 2048: ``peak_estimate`` per device beside the
      card's ``total_memory``, the ladder's final knobs, the roofline
      terms; then ``DRYRUN_CELLS`` on the same mesh (qwen3-moe
      ``train_4k`` flat and grouped, xlstm-1.3b ``decode_32k``,
      granite-8b ``decode_32k``, whisper-small ``train_4k`` and
      ``decode_32k``): each one's peak, roofline terms, collectives and
      trace seconds; any failure is fatal.
11. the sharded chain (Savu's MPI mode): ``standard_chain(n_det=2560,
    n_angles=1800, n_rows=16)`` (1800 angles: 1801 is prime, and 1, 2,
    4 and 8 slots divide 1800), seed 0, on ``CudaTransport`` as the
    one-card reference, then on ``ShardedTransport`` over 4 slots of
    the card and, on a host with two or more cards, over every card,
    each slot set run once untimed first; each
    reconstruction held against the one-card run (rtol 1e-3, atol
    1e-4) with its max abs difference, and where that is not 0 each
    step's difference, carried and its own (fed the one-card run's
    input); the kernels' counts are set to 0 just before each run and
    must read one launch of each kernel per slot (per step, from the
    spans); the all-to-all must move (n − 1)/n of the fp32
    corrected stack; the ring removal's step, whose input is re-split,
    runs under ``torch.profiler`` and must copy nothing through the host
    (memcpy and ``torch.cat`` kernels recorded); then a gang of the
    scan's two 8-row bands through ``PipelineScheduler`` on a sharded
    transport factory over the 4 slots: one gang, no fallback, one
    launch of each kernel per slot, each member against its one-card
    run.  One ``{"sharded_chain": ...}`` line with the card's name and
    power limit.

The line before the last is a JSON object ``{"kernels": [...]}`` (the
correction row also gives the gang launch, ``batched_*``, and the
spectrum-scale row the per-member launch of a 4-variant sweep); the
last line is ``{"ok": true, "device": {...}}``.  Phases 3a-3e print one
``{"service_gang": ...}``, ``{"streaming": ...}``,
``{"stream_resume": ...}``, ``{"http_service": ...}`` and
``{"remote_workers": ...}`` line each; phase 2's family shapes one
``{"flash_attention_families": [...]}`` line, phases 7 and 8 one
``{"families": ...}`` and one ``{"family_parity": ...}`` line, phase 9
one ``{"train": ...}``, ``{"train_parity": ...}`` and
``{"train_resume": ...}`` line, phase 10 its three lines and phase 11
its ``{"sharded_chain": ...}`` line, each with the card's name and
power limit.
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
import contextlib
import dataclasses
import gc
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
#: phase 7: the other families at full width (bf16, random weights from
#: seed 0) and their traffic; ``n_layers`` cuts the depth where all the
#: layers would not fit one 80 GB card (qwen3-moe: 94 layers ~470 GB)
FAMILIES = {
    "qwen3-moe-235b-a22b": {"n_layers": 8, "batcher": True, "requests": 4,
                            "prompt_len": 1024, "max_new": 32, "slots": 4,
                            "max_len": 2048, "grouped": True},
    "llava-next-34b": {"batcher": False, "batch": 2, "patches": 2048,
                       "prompt_len": 64, "max_new": 32, "max_len": 2176},
    "zamba2-1.2b": {"batcher": True, "requests": 4, "prompt_len": 2048,
                    "max_new": 64, "slots": 4, "max_len": 4096},
    "xlstm-1.3b": {"batcher": True, "requests": 4, "prompt_len": 512,
                   "max_new": 32, "slots": 2, "max_len": 1024},
    "whisper-small": {"batcher": False, "batch": 4, "frames": 1500,
                      "prompt_len": 4, "max_new": 64, "max_len": 448},
}
#: phase 7: the grouped run's first prefill logits against the flat
#: run's.  One card is one group, so both compute the same products; the
#: scatter's accumulating index_put_ adds with atomics, whose order (where
#: wrapped positions collide) may round a bf16 buffer either way
GROUPED_LOGITS_ATOL = 5e-2
#: phase 8: the families' smoke configurations, card against CPU, and
#: the MoE configurations' grouped dispatch at each group count (pinned)
FAMILY_PARITY = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "llava-next-34b", "zamba2-1.2b", "xlstm-1.3b",
                 "whisper-small"]
GROUPED_PARITY = [(arch, g) for arch in FAMILY_PARITY[:2] for g in (1, 2, 4)]
#: phase 8's full-width MoE layer (qwen3-moe's widths, bf16, seed 0): the
#: grouped dispatch at g against the flat one on each group on its own
MOE_LAYER = {"arch": "qwen3-moe-235b-a22b", "x": (4, 1024), "groups": 4,
             "rtol": 1e-2, "atol": 1e-3, "reps": 5}
#: phase 9a: granite-8b FULL trained at full width at the repo's
#: ``train_4k`` shape (seq 4096; the global batch cut from 256 to 8, one
#: sequence a microbatch chunk), remat 'dots', fp32 moments; 1 warm-up
#: and 2 timed steps on one repeated batch, then 1 step each with remat
#: 'nothing' and with int8 moments; the depth is cut to what fits
TRAIN = {"arch": "granite-8b", "seq": 4096, "batch": 8, "microbatch": 8,
         "warmup": 1, "timed": 2, "extra_steps": 1, "lr": 3e-4}
#: share of the free device memory the depth estimate leaves to the
#: allocator (fragmentation, the optimizer's per-leaf temporaries)
TRAIN_MARGIN = 0.10
#: phase 10a: compressed_psum on granite-8b's w_up, (d_model, d_ff) fp32
COMPRESS_SHAPE = (4096, 14336)
#: phase 10b: the counted prefill's flops against the products it needs
PREFILL_FLOPS_RTOL = 0.01
#: phase 10c: granite-8b train_4k traced on the fake 16 x 16 mesh at this
#: depth (of 36): each layer costs ~14 s of host time (8 microbatches)
DRYRUN_DEPTH = 2
#: phase 10c: more cells on the same mesh, each (arch, shape, depth,
#: lower_cell's knobs): qwen3-moe's train with perf thread A's knobs,
#: flat (A0) and grouped (A1); xlstm's decode at one whole group of 8;
#: the decode cells and whisper's train that DTensor once refused on
#: torch 2.11 (the train with the ladder's first microbatch count)
DRYRUN_CELLS = [
    ("qwen3-moe-235b-a22b", "train_4k", 2,
     {"microbatch": 8, "remat_policy": "nothing"}),
    ("qwen3-moe-235b-a22b", "train_4k", 2,
     {"microbatch": 8, "remat_policy": "nothing", "moe_grouped": True}),
    ("xlstm-1.3b", "decode_32k", 8, {}),
    ("granite-8b", "decode_32k", 2, {}),
    ("whisper-small", "train_4k", 2, {"microbatch": 8}),
    ("whisper-small", "decode_32k", 2, {}),
]
#: phase 11: the chain at the main width on slots, with 1800 angles: 1801
#: is prime, and by the reference's rule (the split must divide) 1, 2, 4
#: and 8 slots all divide 1800; the slots on one card, and the gang's
#: members (the scan's two 8-row bands, as phase 3a's)
SHARDED = {"n_det": 2560, "n_angles": 1800, "n_rows": 16}
SHARDED_SLOTS = 4
SHARDED_GANG = {"jobs": 2, "n_rows": 8}
#: phase 9b: train steps of each smoke config, card against CPU
TRAIN_PARITY_STEPS = 2
#: phase 9c: launch.train killed once step_<kill_after> is published
RESUME_TRAIN = {"arch": "granite-8b", "steps": 40, "ckpt_every": 10,
                "kill_after": 19}


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


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill: one per attention layer; the shared
    block's applications (Zamba2); the encoder's layers and the decoder's
    self- and cross-attention layers (Whisper); none for xLSTM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // (cfg.attn_every or cfg.n_layers)
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    return cfg.n_layers


def flash_family_shapes() -> dict:
    """Each prefill attention of ``FAMILIES``' traffic, as phase 7 gives it
    to the kernel: name -> (B, Hq, Hkv, Sq, Sk, D, causal).  A batcher
    prefills one request at a time; llava-next's prompt is its patches
    and its tokens; whisper-small's encoder attends over its frames, its
    decoder over its tokens (causal) and across to the frames."""
    from repro_torch.configs import get_config

    shapes = {}
    for arch, run in FAMILIES.items():
        cfg = get_config(arch)
        if cfg.family == "ssm":
            continue
        b = 1 if run["batcher"] else run["batch"]
        heads = (b, cfg.n_heads, cfg.n_kv_heads)
        s = run["prompt_len"] + run.get("patches", 0)
        name = arch
        if cfg.family == "encdec":
            t = run["frames"]
            shapes[f"{arch} encoder"] = (*heads, t, t, cfg.hd, False)
            shapes[f"{arch} cross"] = (*heads, s, t, cfg.hd, False)
            name = f"{arch} decoder"
        shapes[name] = (*heads, s, s, cfg.hd, True)
    return shapes


def flash_family_rows(dev, compare) -> list:
    """Phase 2 at ``flash_family_shapes()``: the kernel against ``mha_ref``
    in bf16 (rtol 1e-2, atol 1e-3) and fp32 (2e-5), its time beside its
    bound from ``cost()``, the plain version's and
    ``scaled_dot_product_attention``'s."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        cost, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for name, (b_, hq, hkv, sq, sk, d_, causal) in \
            flash_family_shapes().items():
        q = torch.randn((b_, hq, sq, d_), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((b_, hkv, sk, d_), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        err = compare(f"flash attention (bf16, {name})",
                      flash_attention_cuda(q, k, v, causal=causal),
                      mha_ref(q, k, v, causal=causal), *FLASH_BF16_TOL)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        err32 = compare(f"flash attention (fp32, {name})",
                        flash_attention_cuda(q32, k32, v32, causal=causal),
                        mha_ref(q32, k32, v32, causal=causal), 2e-5, 2e-5)
        b, by = work_bound(cost(b_, hq, hkv, sq, d_, q.element_size(),
                                causal=causal, sk=sk), PEAK_BF16_FLOPS)
        rows.append({
            "shape": name, "b_hq_hkv_sq_sk_d": [b_, hq, hkv, sq, sk, d_],
            "causal": causal, "max_abs_err": err, "fp32_max_abs_err": err32,
            "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v,
                                                       causal=causal), 20),
            "plain_ms": cuda_ms(lambda: mha_ref(q, k, v, causal=causal), 5),
            "bound_ms": b, "bound_by": by,
            "library_ms": cuda_ms(lambda: sdpa(
                q, k, v, is_causal=causal, enable_gqa=True), 20),
            "fp32_ms": cuda_ms(lambda: flash_attention_cuda(
                q32, k32, v32, causal=causal), 10)})
        del q, k, v, q32, k32, v32
    return rows


def families_phase(dev) -> dict:
    """Phase 7: each family of ``FAMILIES`` at full width on the card, as
    its users call it (``ContinuousBatcher`` or ``greedy_generate``), each
    model freed before the next; fails unless the flash launches are
    exactly one prefill's per prompt, every logit is finite and every
    token lies in the vocabulary.  Then ``PROFILED_STEPS`` decode steps
    of a fresh cache under ``torch.profiler``: the device's busy time
    per step against the step's wall, and the kernels that take most."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.training import (ContinuousBatcher, Request,
                                      greedy_generate, make_serve_step)

    def drive(cfg, model, params, run) -> dict:
        """``run``'s traffic through ``model`` on ``params``; fails unless
        the flash launches are one prefill's per prompt and every logit
        is finite and every token in the vocabulary."""
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        prefill_ms, decode_ms, first = [], [], []

        def timed(fn, times):
            def call(*args):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                logits, cache = fn(*args)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t) * 1e3)
                nonfinite.add_((~torch.isfinite(logits)).sum())
                if times is prefill_ms and not first:
                    first.append(logits.float().cpu())
                return logits, cache
            return call

        served = dataclasses.replace(
            model, prefill=timed(model.prefill, prefill_ms),
            decode_step=timed(model.decode_step, decode_ms))
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=dev).manual_seed(0)
        if run["batcher"]:
            runner = ContinuousBatcher(served, params, slots=run["slots"],
                                       max_len=run["max_len"])
            for i in range(run["requests"]):
                runner.submit(Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab, (run["prompt_len"],)).astype(np.int32),
                    max_new=run["max_new"]))
            prompts = run["requests"]
        else:
            b = run["batch"]
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (b, run["prompt_len"])).astype(np.int32)
            ).to(dev)}
            for name in ("patches", "frames"):
                if name in run:
                    batch[name] = torch.randn(
                        (b, run[name], cfg.d_model), generator=gen,
                        device=dev).to(cfg.dtype)
            prompts = 1
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        if run["batcher"]:
            tokens = [r.generated for r in sorted(runner.run(),
                                                  key=lambda r: r.rid)]
        else:
            tokens = greedy_generate(
                served, params, batch, max_new=run["max_new"],
                max_len=run["max_len"]).tolist()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = flash_attention_cuda.launches
        want = prompts * flash_per_prefill(cfg)
        n_tokens = sum(len(t) for t in tokens)
        arch = cfg.arch_id
        if launches != want:
            fail(f"{arch}: the flash kernel launched {launches} times, "
                 f"expected {want}")
        if len(tokens) != (run["requests"] if run["batcher"]
                           else run["batch"]) or any(
                len(t) != run["max_new"] or not all(
                    0 <= x < cfg.vocab for x in t) for t in tokens):
            fail(f"{arch}: {[len(t) for t in tokens]} tokens, some "
                 f"outside [0, {cfg.vocab})")
        if int(nonfinite):
            fail(f"{arch}: {int(nonfinite)} non-finite logits")
        return {"prefill_ms": prefill_ms,
                "prefill_ms_median": statistics.median(prefill_ms),
                "decode_steps": len(decode_ms),
                "decode_step_ms_median": statistics.median(decode_ms),
                "wall_s": wall, "tokens": n_tokens,
                "tokens_per_s": n_tokens / wall,
                "flash_launches": launches, "flash_launches_expected": want,
                "first_prefill_logits": first[0]}

    report = {}
    for arch, run in FAMILIES.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, use_flash=True, n_layers=run.get(
            "n_layers", full.n_layers))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in params.parameters())
        got = drive(cfg, model, params, run)
        logits = got.pop("first_prefill_logits")
        report[arch] = {
            "width": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab},
            "depth": cfg.n_layers, "depth_full": full.n_layers,
            "traffic": {k: v for k, v in run.items() if k != "n_layers"},
            "weights_bytes": weight_bytes, "init_s": init_s, **got,
            # the model's own peak: what it added to what was resident
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - resident,
            "resident_bytes": resident}
        if run.get("grouped"):
            # the same weights and traffic through the grouped dispatch:
            # one card is one group, so the arithmetic is the flat one's
            gcfg = dataclasses.replace(cfg, moe_grouped=True)
            grouped = drive(gcfg, build_model(gcfg, dev), params, run)
            diff = float((grouped.pop("first_prefill_logits")
                          - logits).abs().max())
            report[arch]["grouped"] = {**grouped,
                                       "first_prefill_max_abs_diff": diff}
            if diff > GROUPED_LOGITS_ATOL:
                fail(f"{arch}: the grouped dispatch's first prefill logits "
                     f"differ from the flat one's by {diff} > "
                     f"{GROUPED_LOGITS_ATOL}")
        del logits
        # where a decode step's time goes, on a fresh cache of the run's
        # batch (the recurrent families' steps cost the same at any
        # position; an attention step attends over all max_len slots)
        step = make_serve_step(model)
        slots = run["slots"] if run["batcher"] else run["batch"]
        cache = model.init_cache(slots, run["max_len"])
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        tok, cache = step(params, tok, cache)
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                tok, cache = step(params, tok, cache)
            torch.cuda.synchronize(dev)
            step_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
        on_card = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        report[arch]["decode_profile"] = {
            "steps": PROFILED_STEPS, "wall_ms_per_step": step_wall_ms,
            "device_busy_ms_per_step": sum(
                e.self_device_time_total for e in on_card) / 1e3
            / PROFILED_STEPS,
            "kernels_per_step": sum(e.count for e in on_card)
            / PROFILED_STEPS,
            "top_kernels_ms_per_step": [
                [e.key[:80], e.self_device_time_total / 1e3 / PROFILED_STEPS]
                for e in on_card[:4]]}
        del model, params, cache, prof
        torch.cuda.empty_cache()
    return report


def family_parity_phase(dev, compare) -> dict:
    """Phase 8: each smoke configuration of ``FAMILY_PARITY`` (fp32) with
    the kernel on the card against the plain versions on the CPU, on the
    same weights: identical greedy tokens, prefill logits within 2e-4,
    one prefill's flash launches on the card and none on the CPU."""
    import copy

    import torch
    from repro_torch.configs import get_config, smoke_batch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.training import greedy_generate

    from repro_torch.models import moe

    report = {}
    runs_of = [(arch, None) for arch in FAMILY_PARITY] + GROUPED_PARITY
    for arch, groups in runs_of:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  use_flash=True,
                                  moe_grouped=groups is not None)
        name = arch if groups is None else f"{arch}_grouped_g{groups}"
        pinned = (mock.patch.object(moe, "_dp_extent", lambda r: groups)
                  if groups else contextlib.nullcontext())
        with pinned:
            report[name] = _parity_run(dev, compare, arch, cfg)
    report["moe_layer"] = moe_layer_check(dev)
    return report


def _parity_run(dev, compare, arch, cfg) -> dict:
    """One smoke configuration on the card and on the CPU (phase 8)."""
    import copy

    import torch
    from repro_torch.configs import smoke_batch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.training import greedy_generate

    batch = smoke_batch(cfg, batch=2, seq=16, seed=3)
    batch.pop("labels")
    weights = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    runs = {}
    for device in (dev, torch.device("cpu")):
        model = build_model(cfg, device)
        params = copy.deepcopy(weights).to(device)
        logits = []

        def prefill(params, batch, max_len, model=model, logits=logits):
            out, cache = model.prefill(params, batch, max_len)
            logits.append(out.cpu())
            return out, cache

        flash_attention_cuda.launches = 0
        tokens = greedy_generate(
            dataclasses.replace(model, prefill=prefill), params, batch,
            max_new=8, max_len=32)
        runs[device.type] = (tokens, logits[0],
                             flash_attention_cuda.launches)
    (card_toks, card_logits, n_card), (cpu_toks, cpu_logits, n_cpu) = \
        runs["cuda"], runs["cpu"]
    if (n_card, n_cpu) != (flash_per_prefill(cfg), 0):
        fail(f"family parity {arch}: {n_card} kernel launches on the "
             f"card, {n_cpu} on the CPU")
    if not np.array_equal(card_toks, cpu_toks):
        fail(f"family parity {arch}: tokens differ, card {card_toks} "
             f"cpu {cpu_toks}")
    return {
        "max_abs_err": compare(f"family parity {cfg.arch_id} (grouped "
                               f"{cfg.moe_grouped}): smoke prefill "
                               f"logits, card vs CPU", card_logits,
                               cpu_logits, 2e-4, 2e-4),
        "flash_launches": n_card, "tokens_identical": True}


def moe_layer_check(dev) -> dict:
    """Phase 8: one MoE layer at qwen3-moe's full widths on the card
    (``MOE_LAYER``): the grouped dispatch at g groups must equal the flat
    dispatch applied to each group's tokens on its own (each with its
    own capacity), and its aux loss the flat one's over all tokens.
    CUDA-event times of the grouped call, the flat call over all tokens
    and the flat calls group by group."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    g = MOE_LAYER["groups"]
    cfg = dataclasses.replace(get_config(MOE_LAYER["arch"]), moe_grouped=True)
    flat = dataclasses.replace(cfg, moe_grouped=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe.init_moe(gen, cfg, cfg.dtype)
    x = torch.randn(MOE_LAYER["x"] + (cfg.d_model,), generator=gen,
                    device=dev).to(cfg.dtype)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    with torch.no_grad(), mock.patch.object(moe, "_dp_extent",
                                            lambda r: g):
        out, aux = moe.moe_fwd(params, x, cfg)
        quarters = x.reshape(g, -1, cfg.d_model)
        want = torch.cat([moe.moe_fwd(params, q[None], flat)[0]
                          for q in quarters]).reshape(x.shape)
        _, flat_aux = moe.moe_fwd(params, x, flat)
        reps = MOE_LAYER["reps"]
        grouped_ms = cuda_ms(lambda: moe.moe_fwd(params, x, cfg), reps)
        flat_ms = cuda_ms(lambda: moe.moe_fwd(params, x, flat), reps)
        per_group_ms = cuda_ms(lambda: [moe.moe_fwd(params, q[None], flat)
                                        for q in quarters], reps)
    err = float((out.float() - want.float()).abs().max())
    if not torch.allclose(out.float(), want.float(), rtol=MOE_LAYER["rtol"],
                          atol=MOE_LAYER["atol"]):
        fail(f"moe layer: grouped (g={g}) differs from the flat dispatch "
             f"per group by {err}")
    if not torch.allclose(aux, flat_aux, rtol=1e-5, atol=0):
        fail(f"moe layer: aux {float(aux)} != flat aux {float(flat_aux)}")
    return {"d_model": cfg.d_model, "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff,
            "x": list(x.shape), "groups": g, "dtype": str(cfg.dtype),
            "expert_weights_bytes": weights,
            "group_buffer_bytes": g * cfg.n_experts * int(
                x.shape[0] * x.shape[1] // g * cfg.top_k
                * cfg.capacity_factor // cfg.n_experts)
            * cfg.d_model * x.element_size(),
            "max_abs_diff_vs_flat_per_group": err,
            "aux": float(aux), "flat_aux": float(flat_aux),
            "grouped_ms": grouped_ms, "flat_ms": flat_ms,
            "flat_per_group_ms": per_group_ms}


# ----------------------------------------------------------------------
# phase 9: training
def train_depth(cfg, free_bytes: float, seq: int, chunk: int) -> dict:
    """How many of ``cfg``'s layers train in ``free_bytes`` at ``seq``
    tokens, ``chunk`` sequences a microbatch, remat 'dots' and fp32
    moments; computed from bytes before the run:

    - per layer: 16 B a parameter (fp32 weight, gradient, m, v), 2 B a
      parameter for the bf16 casts autograd keeps, and what 'dots' saves
      of one chunk (the layer's input, q/k/v, the attention's output
      projection, up, gate and down: bf16);
    - fixed: the two tables' 16 B a parameter; the fp32 logits, their
      gradient and one more temporary of that size; one layer's plain
      attention backward (fp32 scores, probabilities and their gradients,
      four (chunk, heads, seq, seq) tensors);
    - a margin of ``TRAIN_MARGIN`` of the free bytes for the allocator.
    """
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    layer_params = attn + 3 * d * f + 2 * d
    tokens = chunk * seq
    saved = 2 * tokens * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd +
                          3 * d + 2 * f)
    per_layer = 18 * layer_params + saved
    tables = (1 if cfg.tie_embeddings else 2) * cfg.vocab * d + d
    fixed = (16 * tables + 3 * 4 * tokens * cfg.vocab +
             4 * 4 * chunk * cfg.n_heads * seq * seq)
    depth = int((free_bytes * (1 - TRAIN_MARGIN) - fixed) // per_layer)
    return {"depth": max(0, min(cfg.n_layers, depth)),
            "of": cfg.n_layers, "free_bytes": int(free_bytes),
            "per_layer_bytes": int(per_layer), "fixed_bytes": int(fixed),
            "layer_params": int(layer_params), "dots_saved_bytes_per_layer":
            int(saved), "margin": TRAIN_MARGIN}


def _moment_bytes(params, moments: str) -> int:
    """Bytes of the AdamW moments (m and v) of ``params``."""
    total = 0
    for p in params.parameters():
        if moments == "int8":
            rows = p.numel() // p.shape[-1] if p.dim() else 1
            total += 2 * (p.numel() + 4 * rows)
        else:
            total += 2 * 4 * p.numel()
    return total


def train_phase(dev, smi: str) -> dict:
    """Phase 9a: granite-8b ``FULL`` trained at full width (see the module
    docstring)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _q8
    from repro_torch.training import init_training, make_train_step

    t0 = time.perf_counter()
    seq, gb, mb = TRAIN["seq"], TRAIN["batch"], TRAIN["microbatch"]
    full = get_config(TRAIN["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    cut = train_depth(full, torch.cuda.mem_get_info(dev)[0], seq, gb // mb)
    depth = cut["depth"]
    print(json.dumps({"train_depth": cut, "card": smi}), flush=True)
    if depth < 1:
        fail(f"training: no layer of {TRAIN['arch']} fits ({cut})")
    cfg = dataclasses.replace(full, n_layers=depth, remat=True,
                              remat_policy="dots")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in token_stream(
        cfg.vocab, gb, seq, seed=DATA_SEED, step=0).items()}
    resident = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, dev, training=True)
    t = time.perf_counter()
    params, opt = init_training(
        model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    n_all = sum(p.numel() for p in params.parameters())
    # 6·N·tokens counts the products a token meets: not the embedding's
    # row gather
    n_flops = sum(p.numel() for n, p in params.named_parameters()
                  if n != "embed")
    tokens = gb * seq
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=100)

    def run(model, opt_cfg, params, opt, n):
        step = make_train_step(model, opt_cfg, microbatch=mb)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses, gnorms = [], [], []
        for _ in range(n):
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))         # waits for the step
            ms.append((time.perf_counter() - t1) * 1e3)
            gnorms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated(dev) - resident
        if not all(np.isfinite(losses + gnorms)):
            fail(f"training: non-finite loss or grad norm {losses} "
                 f"{gnorms}")
        return params, opt, {"step_ms": ms, "loss": losses,
                             "grad_norm": gnorms, "peak_bytes": peak}

    parts = {"setup_s": time.perf_counter() - t0}
    t = time.perf_counter()
    n_main = TRAIN["warmup"] + TRAIN["timed"]
    params, opt, dots = run(model, opt_cfg, params, opt, n_main)
    timed = dots["step_ms"][TRAIN["warmup"]:]
    step_s = statistics.median(timed) / 1e3
    dots.update({"step_ms_median": step_s * 1e3,
                 "tokens_per_s": tokens / step_s,
                 "mfu": 6 * n_flops * tokens / step_s / PEAK_BF16_FLOPS})
    if not dots["loss"][-1] < dots["loss"][0]:
        fail(f"training: the loss did not fall on a repeated batch "
             f"{dots['loss']}")
    parts["dots_s"] = time.perf_counter() - t

    # where a step's time goes: one step under the profiler (device
    # activity only: the host's op events cost more to record and sort
    # than the step's kernels)
    t = time.perf_counter()
    step = make_train_step(model, opt_cfg, microbatch=mb)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t1) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms > 0:
        fail("training: the profiler recorded no device time in a step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    profile = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "busy_share": busy_ms / wall_ms,
               "top_kernels_ms": [[e.key[:80],
                                   e.self_device_time_total / 1e3,
                                   e.count] for e in top]}
    del prof, kernels, top
    parts["profile_s"] = time.perf_counter() - t

    t = time.perf_counter()
    n_extra = TRAIN["extra_steps"]
    nothing_model = build_model(dataclasses.replace(
        cfg, remat_policy="nothing"), dev, training=True)
    params, opt, nothing = run(nothing_model, opt_cfg, params, opt, n_extra)
    parts["nothing_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fp32_moments = _moment_bytes(params, "fp32")
    # the int8 run goes on from the fp32 moments, quantised: fresh zero
    # moments would make its first update lr · sign(g) on every weight
    opt8 = {"step": opt["step"]}
    for k in ("m", "v"):
        opt8[k] = {}
        while opt[k]:
            name, moment = opt[k].popitem()
            opt8[k][name] = _q8(moment)
            del moment
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    parts["quantise_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params, opt8, int8 = run(model, dataclasses.replace(
        opt_cfg, moments_dtype="int8"), params, opt8, n_extra)
    parts["int8_s"] = time.perf_counter() - t
    for r in (nothing, int8):
        r["step_ms_median"] = statistics.median(r["step_ms"])
    # 'nothing' saves each layer's input too, and rebuilds one layer's
    # saves in its backward
    saved = train_depth(full, 0, seq, gb // mb)["dots_saved_bytes_per_layer"]
    saved -= 2 * (gb // mb) * seq * cfg.d_model
    report = {
        "card": smi, "arch": TRAIN["arch"], "depth": depth,
        "layers_of": full.n_layers, "d_model": cfg.d_model,
        "seq": seq, "global_batch": gb, "microbatch": mb,
        "remat": "dots", "moments": "fp32", "lr": TRAIN["lr"],
        "params": n_all, "params_6nd": n_flops, "init_s": init_s,
        "resident_bytes_before": resident,
        "flops_6nd_per_step": 6 * n_flops * tokens,
        "dots": dots, "profile": profile, "nothing": nothing,
        "int8": int8,
        "peak_dots_minus_nothing": dots["peak_bytes"] - nothing["peak_bytes"],
        "predicted_dots_minus_nothing": (depth - 1) * saved,
        "peak_fp32_minus_int8": dots["peak_bytes"] - int8["peak_bytes"],
        "predicted_fp32_minus_int8": fp32_moments -
        _moment_bytes(params, "int8")}
    if not (nothing["peak_bytes"] < dots["peak_bytes"] and
            int8["peak_bytes"] < dots["peak_bytes"]):
        fail(f"training: remat 'nothing' ({nothing['peak_bytes']}) or int8 "
             f"moments ({int8['peak_bytes']}) did not peak below 'dots' "
             f"with fp32 moments ({dots['peak_bytes']})")
    t = time.perf_counter()
    del params, opt8, model, nothing_model, batch
    gc.collect()
    torch.cuda.empty_cache()
    parts["cleanup_s"] = time.perf_counter() - t
    report["parts_s"] = parts
    return report


def train_parity_phase(dev, smi: str) -> dict:
    """Phase 9b: every architecture's smoke config (fp32): the same
    weights and batch through ``TRAIN_PARITY_STEPS`` train steps on the
    card and on the CPU.  Loss and grad norm within rtol 1e-4 each step.
    Each updated leaf within rtol 1e-4 and atol 1e-2 · lr a step where
    the first gradient is at least 1e-4 of its leaf's max, or is exactly
    0 on both sides (weight decay alone moves those elements).  Elsewhere
    a gradient that differs in its 1e-7 rounding moves Adam's normalised
    step by a share of lr: there within 0.25 · lr a step (the largest
    such difference measured on an H100 is 0.057 · lr a step)."""
    import copy

    import torch
    from repro_torch.configs import ARCH_IDS, get_config, smoke_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.training import init_training, make_train_step

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    steps, lr = TRAIN_PARITY_STEPS, opt_cfg.lr
    report = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        cpu_model = build_model(cfg, "cpu", training=True)
        card_model = build_model(cfg, dev, training=True)
        params, opt = init_training(cpu_model,
                                    torch.Generator().manual_seed(0))
        card_params = copy.deepcopy(params).to(dev)
        card_opt = init_opt_state(card_params)
        batch = smoke_batch(cfg, batch=2, seq=16, seed=3)
        grads = []
        for model, p in ((cpu_model, params), (card_model, card_params)):
            model.loss(p, batch).backward()
            grads.append({n: q.grad.detach().cpu().abs()
                          for n, q in p.named_parameters()})
            for q in p.parameters():
                q.grad = None
        errs = {"loss": 0.0, "grad_norm": 0.0}
        for s in range(steps):
            params, opt, m = make_train_step(cpu_model, opt_cfg)(
                params, opt, batch)
            card_params, card_opt, cm = make_train_step(card_model, opt_cfg)(
                card_params, card_opt, batch)
            for k in errs:
                a, b = float(cm[k]), float(m[k])
                if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
                    fail(f"train parity {arch}: step {s} {k} card {a} "
                         f"cpu {b} (rtol 1e-4)")
                errs[k] = max(errs[k], abs(a - b) / abs(b))
        tight, loose, n_loose, n_zero = 0.0, 0.0, 0, 0
        for (n, a), b in zip(params.named_parameters(),
                             card_params.parameters()):
            a, b = a.detach().double(), b.detach().cpu().double()
            g, cg = grads[0][n], grads[1][n]
            held = (g >= 1e-4 * g.max()) | ((g == 0) & (cg == 0))
            err = (a - b).abs()
            off = err > 1e-2 * lr * steps + 1e-4 * a.abs()
            if (off & held).any() or float(err.max()) > 0.25 * lr * steps:
                fail(f"train parity {arch}: {n} max abs err "
                     f"{float(err.max()):.3e}, {int((off & held).sum())} "
                     f"elements with a large or a zero gradient off")
            tight = max(tight, float(err[held].max()) if held.any() else 0.0)
            loose = max(loose, float(err.max()))
            n_loose += int(off.sum())
            n_zero += int(((g == 0) & (cg == 0)).sum())
        report[arch] = {"loss_rel_err": errs["loss"],
                        "grad_norm_rel_err": errs["grad_norm"],
                        "max_abs_err_held_tight": tight,
                        "max_abs_err": loose, "elements_past_tight": n_loose,
                        "elements_zero_gradient": n_zero}
    return {"card": smi, "steps": steps, "lr": lr, "archs": report}


def train_resume_phase(dev, smi: str) -> dict:
    """Phase 9c: ``python -m repro_torch.launch.train`` (dense smoke, on
    the card): run A uninterrupted and, beside it, run B, the same
    command, SIGKILLed once ``step_<kill_after>`` is published, then run
    again: it must resume at the next step, and its final checkpoint must
    equal A's bit for bit."""
    import os
    import signal

    r = RESUME_TRAIN
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           r["arch"], "--smoke", "--steps", str(r["steps"]),
           "--ckpt-every", str(r["ckpt_every"]), "--log-every", "10",
           "--device", dev.type]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {"card": smi, **r}
    with tempfile.TemporaryDirectory(prefix="train-resume-") as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        # stderr to files: a pipe nobody reads while the runs go on
        # could fill and stop them
        err = {k: open(os.path.join(tmp, f"{k}.err"), "w+")
               for k in ("a", "b")}
        t0 = time.perf_counter()
        run_a = subprocess.Popen(cmd + ["--ckpt-dir", a],
                                 stdout=subprocess.DEVNULL,
                                 stderr=err["a"], env=env)
        marker = os.path.join(b, f"step_{r['kill_after']}")
        proc = subprocess.Popen(cmd + ["--ckpt-dir", b],
                                stdout=subprocess.DEVNULL,
                                stderr=err["b"], env=env)

        def tail(k):
            err[k].seek(0)
            return err[k].read()[-2000:]
        try:
            deadline = time.monotonic() + 600
            while not os.path.isdir(marker):
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail(f"train resume: run B ended ({proc.returncode}) "
                         f"before {marker} appeared: {tail('b')}")
                time.sleep(0.002)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
            kept = sorted(int(n.split("_")[1]) for n in os.listdir(b)
                          if n.startswith("step_"))
            out["killed_with_steps"] = kept
            t1 = time.perf_counter()
            res = subprocess.run(cmd + ["--ckpt-dir", b],
                                 capture_output=True, text=True, env=env,
                                 timeout=600)
            out["run_b2_s"] = time.perf_counter() - t1
            if res.returncode:
                fail(f"train resume: run B again exited {res.returncode}: "
                     f"{res.stderr[-2000:]}")
            try:
                run_a.wait(timeout=600)
            except subprocess.TimeoutExpired:
                fail("train resume: run A did not end within 600 s")
            # from A's and B's start until A and B's second run have ended
            out["runs_s"] = time.perf_counter() - t0
            if run_a.returncode:
                fail(f"train resume: run A exited {run_a.returncode}: "
                     f"{tail('a')}")
        finally:
            for p in (run_a, proc):
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
            for fh in err.values():
                fh.close()
        want = f"resumed from step {r['kill_after']}"
        if want not in res.stdout:
            fail(f"train resume: run B did not print {want!r} (kept "
                 f"{kept}): {res.stdout[-1000:]}")
        out["resumed_at"] = r["kill_after"] + 1
        last = f"step_{r['steps'] - 1}"
        leaves = []
        for d in (a, b):
            with open(os.path.join(d, last, "manifest.json")) as fh:
                n = json.load(fh)["n_leaves"]
            leaves.append([np.load(os.path.join(d, last, f"leaf_{i}.npy"))
                           for i in range(n)])
        diffs = [float(np.abs(x.astype(np.float64) -
                              y.astype(np.float64)).max())
                 for x, y in zip(*leaves)]
        out["leaves"] = len(diffs)
        out["bit_equal"] = all(np.array_equal(x, y)
                               for x, y in zip(*leaves))
        out["max_abs_diff"] = max(diffs)
        if not out["bit_equal"]:
            fail(f"train resume: B's final checkpoint is not A's bit for "
                 f"bit (max |Δ| {out['max_abs_diff']:.3e})")
    return out


# ----------------------------------------------------------------------
# phase 10: compression, the roofline counter, the dry-runs
def compression_phase(dev, smi: str) -> dict:
    """10a: ``compressed_psum`` over a one-rank NCCL group on the card,
    bit for bit against quantise → dequantise on the card and on the
    CPU."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import (compressed_psum, dequantise_int8,
                                         quantise_int8)

    x = torch.randn(COMPRESS_SHAPE, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def roundtrip(t):
        return dequantise_int8(*quantise_int8(t), t.numel(), tuple(t.shape))

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        got = compressed_psum(x, mesh, axis="pod")
        card = roundtrip(x)
        cpu = roundtrip(x.cpu())
        bit_card = torch.equal(got.view(torch.int32), card.view(torch.int32))
        bit_cpu = torch.equal(got.cpu().view(torch.int32),
                              cpu.view(torch.int32))
        if not (bit_card and bit_cpu):
            fail(f"compressed_psum: bit for bit against the card's "
                 f"round trip {bit_card}, against the CPU's {bit_cpu}")
        psum_ms = cuda_ms(lambda: compressed_psum(x, mesh, axis="pod"), 10)
        roundtrip_ms = cuda_ms(lambda: roundtrip(x), 10)
    finally:
        dist.destroy_process_group()
    err = float((got - x).abs().max())
    return {"card": smi, "shape": list(COMPRESS_SHAPE), "dtype": "float32",
            "group": "nccl, 1 rank", "bit_equal_card": bit_card,
            "bit_equal_cpu": bit_cpu, "max_abs_err_vs_input": err,
            "ms": psum_ms, "roundtrip_ms": roundtrip_ms}


def roofline_phase(dev, smi: str, scan) -> dict:
    """10b: the roofline counter around granite-8b's full-width prefill
    of one 2048-token request (the flash kernel launched) and around
    phase 3's chain (the three tomography kernels launched), beside the
    measured time."""
    import torch

    from repro_torch.configs import CellSpec, get_config
    from repro_torch.core import PluginRunner
    from repro_torch.kernels.backproject.kernel import backproject_cuda
    from repro_torch.kernels.correction.kernel import correct_cuda
    from repro_torch.kernels.flash_attention.kernel import (
        cost as flash_cost, flash_attention_cuda)
    from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.models import build_model
    from repro_torch.roofline import Counter, analyse
    from repro_torch.tomo import standard_chain

    def counted(fn, wrappers):
        before = [w.launches for w in wrappers]
        with Counter() as cnt:
            fn()
            torch.cuda.synchronize(dev)
        return cnt, [w.launches - b for w, b in zip(wrappers, before)]

    def wall_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def terms(cnt, ms, **extra):
        roof = analyse(cnt, n_devices=1, **extra)
        bound = max(roof.compute_s, roof.memory_s) * 1e3
        return {"flops": cnt.flops, "bytes": cnt.bytes,
                "compute_s": roof.compute_s, "memory_s": roof.memory_s,
                "bottleneck": roof.bottleneck, "measured_ms": ms,
                "bound_ms": bound, "measured_over_bound": ms / bound}

    # granite-8b FULL, one request of SERVE's prompt length
    cfg = dataclasses.replace(get_config(SERVE["arch"]), use_flash=True)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    s = SERVE["prompt_len"]
    batch = {"tokens": np.random.default_rng(3).integers(0, cfg.vocab,
                                                         (1, s))}

    def prefill():
        return model.prefill(params, batch, SERVE["max_len"])

    prefill()
    cnt, (n_flash,) = counted(prefill, [flash_attention_cuda])
    if n_flash != cfg.n_layers:
        fail(f"roofline prefill: {n_flash} flash launches, expected "
             f"{cfg.n_layers}")
    attn = cfg.n_layers * flash_cost(1, cfg.n_heads, cfg.n_kv_heads, s,
                                     cfg.hd, 2)["flops"]
    products = model_flops(cfg, CellSpec(SERVE["arch"], "prefill", "prefill",
                                         {}, s, 1))
    want = products + attn
    rel = abs(cnt.flops - want) / want
    if rel > PREFILL_FLOPS_RTOL:
        fail(f"roofline prefill: counted {cnt.flops:.6e} flops, expected "
             f"{want:.6e} (2·N·T {products:.6e} + attention {attn:.6e}): "
             f"{rel:.2%} off")
    prefill_row = {**terms(cnt, wall_ms(prefill), model_flops=products),
                   "expected_flops": want, "flops_rel_err": rel,
                   "flash_launches": n_flash}
    del model, params
    torch.cuda.empty_cache()

    # phase 3's chain on phase 3's scan
    def chain():
        pl = standard_chain(**MAIN)
        pl.entries[0].params["scan"] = scan
        return PluginRunner(pl).run()

    chain()
    wrappers = [correct_cuda, scale_spectrum_cuda, backproject_cuda]
    cnt, launched = counted(chain, wrappers)
    if min(launched) < 1:
        fail(f"roofline chain: kernel launches {launched}")
    chain_row = {**terms(cnt, wall_ms(chain)),
                 "launches": dict(zip(("correction", "spectrum_scale",
                                       "backprojection"), launched))}
    return {"card": smi, "prefill": prefill_row, "chain": chain_row}


def dryrun_phase(smi: str) -> dict:
    """10c: granite-8b ``train_4k`` down the memory ladder, the
    tomography chain and ``DRYRUN_CELLS``, on the fake 16 x 16 mesh, on
    the host; fails if any cell fails to trace."""
    import torch

    from repro_torch.launch import dryrun, dryrun_tomo
    from repro_torch.launch.mesh import production_mesh

    total = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    cells = {}
    with production_mesh() as mesh:
        rec = dryrun.ladder("granite-8b", "train_4k", mesh,
                            n_layers=DRYRUN_DEPTH)
        t_lm = time.perf_counter() - t0
        tomo = dryrun_tomo.lower_chain(mesh)
        for arch, shape, depth, knobs in DRYRUN_CELLS:
            tag = f"{arch}__{shape}" + (
                "__grouped" if knobs.get("moe_grouped") else "")
            t = time.perf_counter()
            try:
                r = dryrun.lower_cell(arch, shape, mesh, n_layers=depth,
                                      **knobs)
            except Exception as e:      # noqa: BLE001 — named, then fatal
                fail(f"dryrun {tag}: {type(e).__name__}: {e}")
            cells[tag] = {
                "n_layers": r["n_layers"], "knobs": knobs,
                "peak_estimate": r["memory"]["peak_estimate"],
                "comm_counts": r["comm_counts"], **roof(r),
                "trace_s": time.perf_counter() - t}
    # the one property the chain's dry-run must keep: each PROJECTION ->
    # SINOGRAM transition is one all-to-all, as the reference lowers it
    if (tomo["transitions"] != 1 or tomo["comm_counts"]
            != {"_dtensor.shard_dim_alltoall": 1}):
        fail(f"dryrun_tomo: {tomo['transitions']} transitions, "
             f"collectives {tomo['comm_counts']}; want one all-to-all")
    if rec["memory"]["peak_estimate"] > total:
        fail(f"dryrun granite-8b train_4k: peak_estimate "
             f"{rec['memory']['peak_estimate']} > the card's {total}")
    return {
        "card": smi, "total_memory": total,
        "granite_8b_train_4k": {
            "mesh": rec["mesh"], "n_layers": rec["n_layers"],
            "depth_cut_from": 36, "peak_estimate": rec["memory"][
                "peak_estimate"], "microbatch": rec["microbatch"],
            "remat_policy": rec["remat_policy"], "moments": rec["moments"],
            "comm_counts": rec["comm_counts"], **roof(rec),
            "trace_s": t_lm},
        "tomo_chain": {
            "tag": tomo["tag"], "peak_estimate": tomo["memory"][
                "peak_estimate"], "transitions": tomo["transitions"],
            "comm_counts": tomo["comm_counts"], **roof(tomo)},
        "cells": cells, "torch": torch.__version__,
        "phase_s": time.perf_counter() - t0}


# phase 11: the sharded chain
def sharded_phase(dev, smi: str, compare) -> dict:
    """11: ``standard_chain`` at ``SHARDED`` on one card, then on
    ``ShardedTransport`` over ``SHARDED_SLOTS`` slots of the card and
    over every card when there are two or more, each held against the
    one-card run; the all-to-all's copies under the
    profiler; a gang of ``SHARDED_GANG`` through ``PipelineScheduler`` on
    the slots against each member's one-card run.  Returns the phase's
    numbers; fails on any check."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.core import (CudaTransport, PluginRunner,
                                  ShardedTransport)
    from repro_torch.core.transport import to_tensor
    from repro_torch.kernels.backproject.kernel import backproject_cuda
    from repro_torch.kernels.correction.kernel import correct_cuda
    from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
    from repro_torch.service import CompileCache, JobQueue, PipelineScheduler
    from repro_torch.tomo import (ParallelGeometry, phantom_stack,
                                  simulate_raw_scan, standard_chain)

    t_phase = time.perf_counter()
    wrappers = {"correction": correct_cuda,
                "spectrum_scale": scale_spectrum_cuda,
                "backprojection": backproject_cuda}
    n_det, n_ang, n_rows = (SHARDED["n_det"], SHARDED["n_angles"],
                            SHARDED["n_rows"])
    t0 = time.perf_counter()
    scan = simulate_raw_scan(phantom_stack(n_det, n_rows),
                             ParallelGeometry(n_ang, n_det, n_rows),
                             seed=0, device=dev)
    simulate_s = time.perf_counter() - t0
    stack_bytes = n_ang * n_rows * n_det * 4     # the fp32 corrected stack

    def chain(scan, rows=n_rows):
        pl = standard_chain(n_det=n_det, n_angles=n_ang, n_rows=rows)
        pl.entries[0].params["scan"] = scan
        return pl

    def run(pl, transport):
        """One run with every kernel's count set to 0 just before."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = PluginRunner(pl, transport)
        r.run()
        wall = time.perf_counter() - t0
        return r, wall, {k: w.launches for k, w in wrappers.items()}

    def step_diffs(devices) -> dict:
        """Where the slots' reconstruction differs from one card's: each
        step's output with both chains run through (``carried``), and
        each step on the slots fed the one-card run's input to it
        (``own``: the steps whose own arithmetic depends on the split);
        max abs differences."""
        out: dict = {"carried": {}, "own": {}}
        one_tr, sl_tr = CudaTransport(dev), ShardedTransport(devices)
        one_r, sl_r = (PluginRunner(chain(scan), one_tr),
                       PluginRunner(chain(scan), sl_tr))
        iso_tr = ShardedTransport(devices)
        iso_r = PluginRunner(chain(scan), iso_tr)

        def result(p):
            return to_tensor(p.out_data[0].dataset.materialise(), dev)

        while True:
            p1, p2, p3 = [r.begin_step() for r in (one_r, sl_r, iso_r)]
            if p1 is None:
                break
            p3.in_data[0].dataset.backing = to_tensor(
                p1.in_data[0].dataset.materialise(), dev).clone()
            for tr, p in ((one_tr, p1), (sl_tr, p2), (iso_tr, p3)):
                tr.run_plugin(p)
            want = result(p1)
            out["carried"][p1.name] = float((result(p2) - want).abs().max())
            out["own"][p1.name] = float((result(p3) - want).abs().max())
            for r in (one_r, sl_r, iso_r):
                r.complete_step()
        return out

    # one untimed run on each slot set first: a card's first use pays
    # for its context, its cuFFT plans and its peer access
    run(chain(scan), CudaTransport(dev))
    one, one_wall, one_launches = run(chain(scan), CudaTransport(dev))
    if one_launches != {k: 1 for k in wrappers}:
        fail(f"sharded chain: the one-card run launched {one_launches}")
    ref = one.datasets["recon"].backing
    one_card = {"wall_s": one_wall,
                "process_s": one.profiler.totals("process"),
                "launches": one_launches}
    slot_sets = {f"{dev} x {SHARDED_SLOTS}": (dev,) * SHARDED_SLOTS}
    if torch.cuda.device_count() >= 2:
        slot_sets[f"all {torch.cuda.device_count()} cards"] = "all"
    runs = []
    for label, devices in slot_sets.items():
        run(chain(scan), ShardedTransport(devices))
        tr = ShardedTransport(devices)
        n = len(tr.slots)
        r, wall, launches = run(chain(scan), tr)
        name = f"sharded chain ({label})"
        if launches != {k: n for k in wrappers}:
            fail(f"{name}: launches {launches}, expected {n} of each "
                 f"(one per slot)")
        st = tr.stats()
        if (st["alltoalls"], st["alltoall_bytes"]) != (
                1, stack_bytes * (n - 1) // n):
            fail(f"{name}: all-to-alls {st['alltoalls']} of "
                 f"{st['alltoall_bytes']} B, expected 1 of "
                 f"{stack_bytes * (n - 1) // n}")
        recon = r.datasets["recon"].backing
        err = compare(f"{name} vs one card", recon.to(dev), ref,
                      1e-3, 1e-4)
        per_step = {e.plugin: {k.split(".", 1)[1]: v
                               for k, v in e.extra.items()
                               if k.startswith("launches.")}
                    for e in r.profiler.events if e.phase == "process"}
        want = {"dark_flat_correction": {"correction": n},
                "ring_removal": {},
                "sinogram_filter": {"spectrum_scale": n},
                "fbp_recon": {"backprojection": n}}
        if per_step != want:
            fail(f"{name}: launches per step {per_step}, expected {want}")
        rec = {"slots": st["slots"], "wall_s": wall,
               "process_s": r.profiler.totals("process"),
               "max_abs_diff_vs_one_card": err, "launches": launches,
               "launches_per_step": per_step,
               "alltoall_bytes": st["alltoall_bytes"],
               "alltoall_s": st["alltoall_s"]}
        if err != 0.0:
            rec["step_diffs"] = step_diffs(devices)
        runs.append(rec)
        del r, recon
        torch.cuda.empty_cache()

    # the all-to-all's copies: the ring removal's step, whose input is
    # re-split first, under the profiler; nothing may cross the host
    copies = {}
    for label, devices in slot_sets.items():
        tr = ShardedTransport(devices)
        r = PluginRunner(chain(scan), tr)
        r.step()                              # the correction
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            r.step()                          # re-split, ring removal
        events = {e.key: {"count": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        host = [k for k in events if "HtoD" in k or "DtoH" in k]
        if host:
            fail(f"sharded chain ({label}): the all-to-all step copied "
                 f"through the host: {host}")
        # between cards a block crosses as a memcpy (PtoP or DtoD); on
        # one card each slot's torch.cat copies its blocks
        copies[label] = {
            "memcpy": {k: v for k, v in events.items()
                       if k.startswith("Memcpy")},
            "cat": {k[:60]: v for k, v in events.items() if "Cat" in k},
            "device_events": sum(v["count"] for v in events.values())}
        del r, tr
    torch.cuda.empty_cache()

    # 11b: a gang of two 8-row bands on the slots, one call a step
    rows_g = SHARDED_GANG["n_rows"]
    bands = []
    for j in range(SHARDED_GANG["jobs"]):
        lo = j * rows_g
        bands.append({"data": np.ascontiguousarray(
                          scan["data"][:, lo:lo + rows_g]),
                      "dark": scan["dark"][lo:lo + rows_g],
                      "flat": scan["flat"][lo:lo + rows_g],
                      "mu": scan["mu"],
                      "truth": scan["truth"][lo:lo + rows_g]})
    cache = CompileCache()
    slots = (dev,) * SHARDED_SLOTS
    q = JobQueue()
    sched = PipelineScheduler(
        q, n_workers=1, batch_identical=True,
        batch_max=SHARDED_GANG["jobs"], compile_cache=cache,
        transport_factory=lambda job: ShardedTransport(
            slots, compile_cache=cache))
    jobs = q.submit_many([chain(b, rows_g) for b in bands])
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        sched.start()
        if not sched.drain(timeout=600):
            fail("sharded gang: timed out")
    finally:
        sched.shutdown()
    gang_wall = time.perf_counter() - t0
    gang_launches = {k: w.launches for k, w in wrappers.items()}
    st = sched.stats()
    if st["gangs_run"] != 1 or st["gang_fallbacks"]:
        fail(f"sharded gang: {st['gangs_run']} gangs, "
             f"{st['gang_fallbacks']} fallbacks; expected 1 and 0")
    if gang_launches != {k: SHARDED_SLOTS for k in wrappers}:
        fail(f"sharded gang: launches {gang_launches}, expected "
             f"{SHARDED_SLOTS} of each (one per slot for the gang)")
    gang_errs = []
    for j, (job, band) in enumerate(zip(jobs, bands)):
        if job.state.value != "done":
            fail(f"sharded gang: member {j} {job.state.value}: {job.error}")
        solo, _, _ = run(chain(band, rows_g), CudaTransport(dev))
        gang_errs.append(compare(
            f"sharded gang member {j} vs its one-card run",
            job.runner.datasets["recon"].backing.to(dev),
            solo.datasets["recon"].backing, 1e-3, 1e-4))
    return {
        "card": smi, "chain": SHARDED, "simulate_s": simulate_s,
        "corrected_stack_bytes": stack_bytes, "one_card": one_card,
        "runs": runs, "alltoall_copies": copies,
        "gang": {"jobs": SHARDED_GANG["jobs"], "n_rows_per_job": rows_g,
                 "slots": SHARDED_SLOTS, "wall_s": gang_wall,
                 "step_s": jobs[0].runner.profiler.totals("process"),
                 "launches": gang_launches,
                 "max_abs_diff_vs_one_card": gang_errs},
        "phase_s": time.perf_counter() - t_phase}


def roof(r: dict) -> dict:
    """A dry-run record's roofline terms."""
    return {k: r["roofline"][k] for k in (
        "compute_s", "memory_s", "collective_s", "bottleneck",
        "useful_ratio", "coll_detail")}


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
    del sino, spec, got, part

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
    print(json.dumps({"flash_attention_families": flash_family_rows(
        dev, compare)}))
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
    scan3 = scan                     # phase 10b counts the chain on it
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
    del runs, first, second, job, sched, queue, recon3, frames, scan
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
    torch.cuda.empty_cache()

    # -- 7. the other families at full width --------------------------------
    # what earlier phases left on the card goes first
    del recon
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    families = families_phase(dev)
    print(json.dumps({"families": families,
                      "phase_s": time.perf_counter() - t0}), flush=True)

    # -- 8. family parity: kernels on the card vs plain versions on the CPU
    t0 = time.perf_counter()
    parity = family_parity_phase(dev, compare)
    print(json.dumps({"family_parity": parity,
                      "phase_s": time.perf_counter() - t0}), flush=True)

    # -- 9. training: granite-8b at full width, parity, kill and resume ----
    t0 = time.perf_counter()
    print(json.dumps({"train": train_phase(dev, smi),
                      "phase_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    print(json.dumps({"train_parity": train_parity_phase(dev, smi),
                      "phase_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    print(json.dumps({"train_resume": train_resume_phase(dev, smi),
                      "phase_s": time.perf_counter() - t0}), flush=True)

    # -- 10. compression, the roofline counter, the dry-runs ---------------
    t0 = time.perf_counter()
    print(json.dumps({"compression": compression_phase(dev, smi),
                      "phase_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    print(json.dumps({"roofline": roofline_phase(dev, smi, scan3),
                      "phase_s": time.perf_counter() - t0}), flush=True)
    del scan3
    torch.cuda.empty_cache()
    print(json.dumps({"dryrun": dryrun_phase(smi)}), flush=True)

    # -- 11. the sharded chain ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"sharded_chain": sharded_phase(dev, smi, compare)}),
          flush=True)

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
