"""Perf hillclimb: re-traces the three chosen cells with one
knob flipped per iteration and records before/after JSON pairs in
experiments/perf/.  A run that fails writes ``<name>.FAIL`` with its
traceback and the next run goes on, as in ``dryrun.run_cells``.  The
threads and record names are the reference's: A (qwen3-moe train_4k,
the flat against the grouped MoE dispatch), B (granite-34b decode_32k)
and C (llava-next-34b train_4k); ``round2`` runs A3, B2 and B3.

    PYTHONPATH=src python -m repro_torch.launch.perf --thread A
    ... --thread A3 --n-layers 2      # each cell cut to 2 layers

``--n-layers`` cuts every run's depth as ``dryrun --n-layers`` does
(``dryrun.cut_depth``); a traced layer costs seconds of host time.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import traceback

import torch

from .dryrun import lower_cell
from .mesh import production_mesh

OUT = "experiments/perf"


def save(name, arch, shape, *, mesh, **knobs):
    """Trace one cell on ``mesh`` with ``knobs`` and write
    ``<name>.json``, or ``<name>.FAIL`` with the traceback when the trace
    fails."""
    os.makedirs(OUT, exist_ok=True)
    try:
        rec = lower_cell(arch, shape, mesh, **knobs)
    except Exception as e:     # noqa: BLE001 — one run's failure
        print(f"{name:52s} FAIL {type(e).__name__}: {e}", flush=True)
        with open(os.path.join(OUT, name + ".FAIL"), "w") as fh:
            fh.write(traceback.format_exc())
        return None
    with open(os.path.join(OUT, name + ".json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    ro = rec["roofline"]
    print(f"{name:52s} mem/dev={rec['memory']['peak_estimate'] / 2**30:7.2f}GiB "
          f"comp={ro['compute_s'] * 1e3:9.1f} mem={ro['memory_s'] * 1e3:9.1f} "
          f"coll={ro['collective_s'] * 1e3:9.1f} -> {ro['bottleneck']}",
          flush=True)
    return rec


def thread_a(run):
    """qwen3-moe train_4k: MoE dispatch collective volume."""
    base = dict(microbatch=8, remat_policy="nothing")
    run("A0_qwen3_train_flat", "qwen3-moe-235b-a22b", "train_4k",
        **base)
    run("A1_qwen3_train_grouped", "qwen3-moe-235b-a22b", "train_4k",
        moe_grouped=True, **base)
    # A2: grouped + no-SP (does SP still pay under grouped dispatch?)
    run("A2_qwen3_train_grouped_nosp", "qwen3-moe-235b-a22b",
        "train_4k", moe_grouped=True, sp=False, **base)


def thread_a3(run):
    """A3: grouped dispatch + explicit ZeRO-3 gather of expert weights
    (contract-over-sharded-d otherwise all-reduces full partials); the
    gather is in the grouped dispatch itself, so A3's knobs are A1's."""
    run("A3_qwen3_train_grouped_zero3gather", "qwen3-moe-235b-a22b",
        "train_4k", moe_grouped=True, microbatch=8, remat_policy="nothing")


def thread_b(run):
    """granite-34b decode_32k: serving memory floor."""
    run("B0_g34_decode_fp32params", "granite-34b", "decode_32k")
    run("B1_g34_decode_bf16params", "granite-34b", "decode_32k",
        param_dtype=torch.bfloat16)


def thread_b2(run):
    """B2: is the decode collective the seq-sharded (split-K) cache?"""
    run("B2_g34_decode_no_kvseq", "granite-34b", "decode_32k",
        rules_overrides={"kv_seq": None})


def thread_b3(run):
    """B3: TP-only bf16 weights for serving (no per-layer FSDP weight
    all-gathers; decode batch can't amortise them)."""
    run("B3_g34_decode_tp_only_bf16", "granite-34b", "decode_32k",
        param_dtype=torch.bfloat16, serve_params="serve")


def thread_c(run):
    """llava train_4k: 56 heads don't divide the 16-way TP axis."""
    base = dict(microbatch=16, remat_policy="nothing")
    run("C0_llava_train_replicated_heads", "llava-next-34b",
        "train_4k", **base)
    run("C1_llava_train_seqshard", "llava-next-34b", "train_4k",
        seq_fallback=True, **base)
    # C2: seq-fallback + tighter microbatch
    run("C2_llava_train_seqshard_dots", "llava-next-34b", "train_4k",
        seq_fallback=True, microbatch=16, remat_policy="dots")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--thread", default="all",
                    choices=["A", "A3", "B", "B2", "B3", "C", "all",
                             "round2"])
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut every run's depth (dryrun.cut_depth)")
    args = ap.parse_args()
    with production_mesh() as mesh:
        run_threads(args.thread, mesh, n_layers=args.n_layers)


def run_threads(thread: str, mesh, n_layers: int | None = None) -> None:
    """The runs of ``thread`` on ``mesh``, each cut to ``n_layers``
    (``dryrun.cut_depth``; None keeps the configs' depths)."""
    run = functools.partial(save, mesh=mesh, n_layers=n_layers)
    if thread in ("A", "all"):
        thread_a(run)
    if thread in ("B", "all"):
        thread_b(run)
    if thread in ("C", "all"):
        thread_c(run)
    if thread in ("A3", "round2"):
        thread_a3(run)
    if thread in ("B2", "round2"):
        thread_b2(run)
    if thread in ("B3", "round2"):
        thread_b3(run)


if __name__ == "__main__":
    main()
